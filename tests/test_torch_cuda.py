"""PyTorch port on the CUDA card: each kernel against its plain version at
edge shapes (ragged stage-2 rows, several stage-1 column tiles, one row
tile), and the engine on the card against the port on the CPU. Every test
here needs a card and skips without one. The module imports neither jax
nor the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pyrhe_tpu_torch.io.bed import clean_packed, encode_dosage
from pyrhe_tpu_torch.ops import kernels as tk
from pyrhe_tpu_torch.ops.moments import _hilo

torch.set_num_threads(2)

RTOL = 1e-4     # f32 summation order of the kernel vs the plain product


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run: python -m pytest "
                    "--noconftest tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def make_block(m, n, seed):
    rng = np.random.default_rng(seed)
    dos = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    dos[rng.random((m, n)) < 0.05] = 255
    fill = rng.integers(0, 3, size=m).astype(np.float64)
    m_pad, n_pad = tk.pad_to(m, tk.ROW_TILE), tk.pad_to(n, tk.TN)
    clean = np.zeros((m_pad, n_pad // 4), np.uint8)
    clean_packed(encode_dosage(dos), fill, out=clean[:m])
    perm = tk.plane_permutation(n_pad)
    return clean.view(np.int32), perm, m, n, m_pad, n_pad


def assert_close(got, ref):
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("m,n,W,Q", [
    (300, 2500, 22, 40),      # a few row and column tiles
    (20, 700, 61, 7),         # one row tile, 3-6 column tiles, ragged Q
    (1000, 4096, 12, 160),    # the K = 8 stage-2 width
])
def test_cuda_kernels_match_plain(cuda_device, split, m, n, W, Q):
    words, perm, m, n, m_pad, n_pad = make_block(m, n, seed=m + n)
    gen = torch.Generator(device=cuda_device).manual_seed(W + Q)
    w = torch.from_numpy(words).to(cuda_device)
    C = torch.randn(n_pad, W, device=cuda_device, generator=gen)
    Yt = torch.randn(Q, m_pad, device=cuda_device, generator=gen)
    Yt[:, m:] = 0.0
    if split:
        C, Yop = _hilo(C, 1).contiguous(), _hilo(Yt, 0).contiguous()
    else:
        Yop = Yt
    before = [fn.launches for fn in tk.KERNELS]
    assert_close(tk.gp_matmul(w, C), tk.gp_plain(w, C))
    assert_close(tk.ytg_matmul(w, Yop), tk.ytg_plain(w, Yop))

    rank1 = torch.randn(Q, 1, device=cuda_device, generator=gen)
    mask = torch.tensor((perm < n)[None, :], dtype=torch.float32,
                        device=cuda_device)
    for scale in (torch.ones(1, n_pad, device=cuda_device),
                  torch.randn(1, n_pad, device=cuda_device, generator=gen)):
        tot0 = torch.randn(Q, n_pad, device=cuda_device, generator=gen)
        got = tk.ytg_acc_matmul(w, Yop, rank1, scale, mask, tot0.clone(),
                                split=split)
        a = tk.ytg_matmul(w, Yop)
        if split:
            a = a[:Q] + a[Q:]
        assert torch.equal(got, tot0 + ((a - rank1) * scale) * mask)
        assert_close(got, tk.ytg_acc_plain(w, Yop, rank1, scale, mask,
                                           tot0.clone(), split))
    assert [fn.launches - b for fn, b in zip(tk.KERNELS, before)] == [1, 3, 2]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from pyrhe_tpu_torch.io import synth
    d = tmp_path_factory.mktemp("cuda_data")
    prefix = str(d / "test")
    synth.make_dataset(prefix, 900, 1200, seed=3, missing_rate=0.01)
    a8 = synth.make_annot(str(d / "multi.annot"), 1200, 8, seed=4)
    cov = synth.make_cov_file(str(d / "test.cov"), 900, num_cov=3, seed=3)
    synth.simulate_pheno_file(prefix, prefix, [0.05] * 8, a8, seed=5,
                              cov=cov)
    return prefix, str(d / "multi.annot"), str(d / "test.cov")


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_and_streaming(cuda_device, dataset):
    from pyrhe_tpu_torch.core.data import load_dataset
    from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig

    prefix, annot, cov = dataset

    def run(device, streaming):
        data = load_dataset(prefix, annot_file=annot,
                            pheno_file=prefix + ".pheno", cov_file=cov,
                            num_random_vec=6, seed=7)
        eng = Engine(data, ModelSpec.build("rhe"),
                     RunConfig(num_random_vec=6, num_jack=6, seed=7,
                               device=device, streaming=streaming))
        eng.run_precompute_and_assemble()
        return eng

    cpu, cached, streaming = (run("cpu", False), run("cuda", False),
                              run("cuda", True))
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)
    _, st_cpu = cpu.estimate(0)
    _, st = cached.estimate(0)
    # split2 envelope (tests/test_engine_vs_oracle.py)
    np.testing.assert_allclose(st, st_cpu, rtol=3e-4,
                               atol=3e-4 * np.abs(st_cpu).max())
