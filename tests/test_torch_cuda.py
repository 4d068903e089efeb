"""PyTorch port on the CUDA card: each kernel against its plain version at
edge shapes (ragged stage-2 rows, several stage-1 column tiles, one row
tile) with f32, split2 and unsplit bf16 operands; the engine on the card
against the port on the CPU (float32, and float64 at rtol 1e-10); bf16
streaming == cached, and the hybrid and host caches bitwise equal to the
full cache. Every test here needs a card and skips without one. The module imports neither jax
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
    Yt2 = torch.randn(Q, m_pad, device=cuda_device, generator=gen)
    Yt2[:, m:] = 0.0
    if split:
        C, Yop = _hilo(C, 1).contiguous(), _hilo(Yt, 0).contiguous()
        Yop2 = _hilo(Yt2, 0).contiguous()
    else:
        Yop, Yop2 = Yt, Yt2
    before = dict(tk.launches)
    for square in (False, True):
        assert_close(tk.gp_matmul(w, C, square), tk.gp_plain(w, C, square))
        assert_close(tk.ytg_matmul(w, Yop, square),
                     tk.ytg_plain(w, Yop, square))

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

    tot0 = torch.randn(Q, n_pad, device=cuda_device, generator=gen)
    got = tk.ytg_acc2_matmul(w, Yop, Yop2, rank1, mask, tot0.clone(),
                             split=split)
    a1 = tk.sum_halves(tk.ytg_matmul(w, Yop), split)
    a2 = tk.sum_halves(tk.ytg_matmul(w, Yop2, square=True), split)
    assert torch.equal(got, tot0 + ((a1 + a2) - rank1) * mask)
    assert_close(got, tk.ytg_acc2_plain(w, Yop, Yop2, rank1, mask,
                                        tot0.clone(), split))
    # gp, gp square, ytg, ytg square, ytg_acc, ytg_acc2 (tk.KERNELS order)
    assert [tk.launches[k] - before[k] for k in tk.KERNELS] == [
        1, 1, 4, 2, 2, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["f32", "split", "bf16"])
@pytest.mark.parametrize("W", [1, 8, 44, 61])
@pytest.mark.parametrize("m,n", [
    (20, 700),                # m_pad 32 < one 128-row tile, S = 1
    (300, 10000),             # three row tiles, S = 5 (gp_splits)
])
def test_cuda_gp_split_k(cuda_device, operand, W, m, n):
    """gp and gp² against the plain version at ragged widths (odd bf16
    widths take the 2-byte copy) and at one and several K splits; two
    launches bitwise equal; the product against a float64 one (split: the
    two halves summed, against the f32 C they came from)."""
    words, perm, m, n, m_pad, n_pad = make_block(m, n, seed=m + W)
    assert tk.gp_splits(m_pad, n_pad)[1] == (1 if n_pad == 2048 else 5)
    gen = torch.Generator(device=cuda_device).manual_seed(W)
    w = torch.from_numpy(words).to(cuda_device)
    C = C32 = torch.randn(n_pad, W, device=cuda_device, generator=gen)
    if operand == "bf16":
        C = C32.to(torch.bfloat16)
        C32 = C.float()
    split = operand == "split"
    C = _hilo(C32, 1).contiguous() if split else C
    for square in (False, True):
        got = tk.gp_matmul(w, C, square)
        assert got.shape == (m_pad, C.shape[1])
        assert torch.equal(got, tk.gp_matmul(w, C, square))
        assert_close(got, tk.gp_plain(w, C, square))
        ref = tk.decode_words(w, square).double() @ C32.double()
        if split:
            got = got[:, :W] + got[:, W:]
        # split2 keeps ~16 bits of C: |C - hi - lo| <= 2^-17 |C| per term
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   ref.cpu().numpy(), rtol=2e-4,
                                   atol=2e-4 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("operand", ["f32", "split", "bf16"])
@pytest.mark.parametrize("m,n,Q", [
    (20, 700, 7),             # m_pad 32 (two k16 steps), 14 split rows
    (300, 2500, 40),          # several row and word tiles, ragged rows
    (1000, 4096, 160),        # RHE's 160 rows: unsplit bf16 takes 2.5
                              # 64-row tiles, split 5 32-row ones
    (1000, 4096, 320),        # 640 split rows: RHE-DOM's g-side ytg
])
def test_cuda_ytg_family(cuda_device, square, operand, m, n, Q):
    """ytg (ytg² when square) against the plain version; two launches
    bitwise equal; the product (split: the two halves summed) against a
    float64 one of the f32 Yt the operand came from; ytg_acc (square off)
    or ytg_acc2 (square on) bitwise equal to ytg + the tensor transform."""
    words, perm, m, n, m_pad, n_pad = make_block(m, n, seed=m + Q)
    gen = torch.Generator(device=cuda_device).manual_seed(Q)
    w = torch.from_numpy(words).to(cuda_device)
    split = operand == "split"

    def make_operand():
        """(kernel operand, the f32 Yt it stands for)"""
        Y32 = torch.randn(Q, m_pad, device=cuda_device, generator=gen)
        Y32[:, m:] = 0.0
        if operand == "bf16":
            Y = Y32.to(torch.bfloat16)
            return Y, Y.float()
        return (_hilo(Y32, 0).contiguous() if split else Y32), Y32

    Yop, Y32 = make_operand()
    got = tk.ytg_matmul(w, Yop, square)
    assert got.shape == (Yop.shape[0], n_pad)
    assert torch.equal(got, tk.ytg_matmul(w, Yop, square))
    assert_close(got, tk.ytg_plain(w, Yop, square))
    ref = Y32.double() @ tk.decode_words(w, square).double()
    # split2 keeps ~16 bits of Yt: |Y - hi - lo| <= 2^-17 |Y| per term;
    # the f32 sums (FMA chain or tensor cores) add ~1e-6 of max |ref|
    np.testing.assert_allclose(
        tk.sum_halves(got, split).double().cpu().numpy(), ref.cpu().numpy(),
        rtol=2e-4, atol=2e-4 * ref.abs().max().item())

    rank1 = torch.randn(Q, 1, device=cuda_device, generator=gen)
    mask = torch.tensor((perm < n)[None, :], dtype=torch.float32,
                        device=cuda_device)
    tot0 = torch.randn(Q, n_pad, device=cuda_device, generator=gen)
    a = tk.sum_halves(tk.ytg_matmul(w, Yop), split)
    if not square:
        scale = torch.randn(1, n_pad, device=cuda_device, generator=gen)
        out = tk.ytg_acc_matmul(w, Yop, rank1, scale, mask, tot0.clone(),
                                split=split)
        assert torch.equal(out, tot0 + ((a - rank1) * scale) * mask)
        assert_close(out, tk.ytg_acc_plain(w, Yop, rank1, scale, mask,
                                           tot0.clone(), split))
    else:
        Yop2, _ = make_operand()
        out = tk.ytg_acc2_matmul(w, Yop, Yop2, rank1, mask, tot0.clone(),
                                 split=split)
        a2 = tk.sum_halves(tk.ytg_matmul(w, Yop2, square=True), split)
        assert torch.equal(out, tot0 + ((a + a2) - rank1) * mask)
        assert_close(out, tk.ytg_acc2_plain(w, Yop, Yop2, rank1, mask,
                                            tot0.clone(), split))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from pyrhe_tpu_torch.io import synth
    d = tmp_path_factory.mktemp("cuda_data")
    prefix = str(d / "test")
    synth.make_dataset(prefix, 900, 1200, seed=3, missing_rate=0.01)
    a8 = synth.make_annot(str(d / "multi.annot"), 1200, 8, seed=4)
    cov = synth.make_cov_file(str(d / "test.cov"), 900, num_cov=3, seed=3)
    synth.make_env_file(str(d / "test.env"), 900, num_env=2, seed=3)
    synth.simulate_pheno_file(prefix, prefix, [0.05] * 8, a8, seed=5,
                              cov=cov)
    return (prefix, str(d / "multi.annot"), str(d / "test.cov"),
            str(d / "test.env"))


def run_engine(dataset, model, device, **cfg):
    """One engine run on the module's dataset (GENIE: G+GxE+NxE, two
    environments)."""
    from pyrhe_tpu_torch.core.data import load_dataset
    from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig

    prefix, annot, cov, env = dataset
    data = load_dataset(prefix, annot_file=annot,
                        pheno_file=prefix + ".pheno", cov_file=cov,
                        env_file=env if model == "genie" else None,
                        num_random_vec=6, seed=7)
    eng = Engine(data, ModelSpec.build(model, "G+GxE+NxE", data.num_env),
                 RunConfig(num_random_vec=6, num_jack=6, seed=7,
                           device=device, **cfg))
    eng.run_precompute_and_assemble()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_cuda_engine_matches_cpu_and_streaming(cuda_device, dataset, model):
    """The engine on the card against the port on the CPU, and cached ==
    streaming bitwise on the card; GENIE runs G+GxE+NxE with two
    environments (env-scaled gp columns, the env column as ytg_acc's
    scale, analytic NxE rows)."""
    cpu, cached, streaming = (run_engine(dataset, model, "cpu"),
                              run_engine(dataset, model, "cuda"),
                              run_engine(dataset, model, "cuda",
                                         streaming=True))
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)
    _, st_cpu = cpu.estimate(0)
    _, st = cached.estimate(0)
    # split2 envelope (tests/test_engine_vs_oracle.py)
    np.testing.assert_allclose(st, st_cpu, rtol=3e-4,
                               atol=3e-4 * np.abs(st_cpu).max())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_cuda_float64_matches_cpu(cuda_device, dataset, model):
    """float64 (mm_mode exact: torch products, no kernel) on the card
    against the CPU at rtol 1e-10 (atol 1e-12 of the largest entry), and
    streaming == cached bitwise on the card."""
    cpu = run_engine(dataset, model, "cpu", dtype="float64")
    cached = run_engine(dataset, model, "cuda", dtype="float64")
    streaming = run_engine(dataset, model, "cuda", dtype="float64",
                           streaming=True)
    assert cached.mode == "exact"
    for got, want in ((cached.T_all, cpu.T_all), (cached.q_all, cpu.q_all)):
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_cuda_bf16_streaming_equals_cached(cuda_device, dataset, model):
    """mm_mode bf16 on the card: the kernels with unsplit bf16 operands,
    ytg_acc / ytg_acc2 in streaming pass 1; bitwise equal to cached, and
    within the bf16 envelope (3e-2) of the float64 run."""
    before = dict(tk.launches)
    cached = run_engine(dataset, model, "cuda", dtype="bfloat16")
    streaming = run_engine(dataset, model, "cuda", dtype="bfloat16",
                           streaming=True)
    acc = "ytg_acc2_matmul" if model == "rhe_dom" else "ytg_acc_matmul"
    assert tk.launches[acc] > before[acc]
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)
    _, st64 = run_engine(dataset, model, "cuda", dtype="float64").estimate(0)
    _, st = cached.estimate(0)
    np.testing.assert_allclose(st, st64, rtol=3e-2,
                               atol=3e-2 * np.abs(st64).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_hybrid_and_host_cache_bitwise(cuda_device, dataset, dtype):
    """RHE-DOM on the card: cache_blocks 0 and 3 and streaming with the
    host cache (no second read: 6 hits) bitwise equal to the full cache."""
    full = run_engine(dataset, "rhe_dom", "cuda", dtype=dtype)
    for cfg in (dict(cache_blocks=0), dict(cache_blocks=3),
                dict(streaming=True, host_cache_gb=1.0)):
        eng = run_engine(dataset, "rhe_dom", "cuda", dtype=dtype, **cfg)
        np.testing.assert_array_equal(eng.T_all, full.T_all)
        np.testing.assert_array_equal(eng.q_all, full.q_all)
    assert eng.phase_times["host_cache_hits"] == 6
