"""PyTorch port on the CUDA card: each kernel against its plain version at
edge shapes (ragged stage-2 rows, several stage-1 column tiles, one row
tile) with f32, split2 and unsplit bf16 operands; the engine on the card
against the port on the CPU (float32, and float64 at rtol 1e-10); the
pass-2 kernel against its plain version and once a jackknife sample; bf16
streaming == cached, and the hybrid and host caches bitwise equal to the
full cache; checkpointed runs crashed and resumed bitwise; the phenotype
sweep's merged traits bitwise equal to solo runs; and run_sharded() at
world size 1 over NCCL bitwise equal to the sequential engine. Every test
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
    # gp, gp square, ytg, ytg square, ytg_acc, ytg_acc2, sample_contract
    # (tk.KERNELS order)
    assert [tk.launches[k] - before[k] for k in tk.KERNELS] == [
        1, 1, 4, 2, 2, 1, 0]


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


def sample_inputs(E_geno, num_nxe, B, ncov, N, dtype, dev, drop=True):
    """One jackknife sample's kernel operands (tot, drop, nxe, Ct, Zt, Ut),
    random, of dtype on dev; N-indexed rows contiguous."""
    gen = torch.Generator(device=dev).manual_seed(E_geno * 1000 + B + N)
    b2 = 2 * B if ncov else B

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    return (rand(E_geno, b2, N), rand(E_geno, b2, N) if drop else None,
            rand(num_nxe, b2, N) if num_nxe else None,
            rand(ncov, N) if ncov else None, rand(B, N),
            rand(B, N) if ncov else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("E_geno,num_nxe,B,ncov,N,drop", [
    (24, 2, 10, 4, 100352, True),     # genie.cached's samples (E = 26)
    (8, 0, 50, 4, 100352, True),      # rhe_k50's (b2 = 100)
    (8, 0, 50, 4, 100352, False),     # its full sample: tot alone
    (33, 0, 3, 2, 5000, True),        # E = 33: tile groups; a ragged chunk
    (38, 2, 3, 4, 5000, True),        # E = 40: 95 tiles, f32 two a thread
                                      # in two groups (f64: three)
    (5, 1, 4, 0, 4099, True),         # no covariates; N % 4 != 0
    (1, 0, 1, 0, 2048, False),        # one row, one probe
])
def test_cuda_sample_contract_matches_plain(cuda_device, dtype, E_geno,
                                            num_nxe, B, ncov, N, drop):
    """The pass-2 kernel against its plain version on the same stats (X =
    tot - drop rounded in dtype, then float64 sums): each output within
    1e-5 (float32: runs of at most 256 float32 terms) or 1e-13 (float64) of
    the sum of its terms' magnitudes; two launches bitwise equal; one launch
    a call."""
    ops = sample_inputs(E_geno, num_nxe, B, ncov, N, dtype, cuda_device,
                        drop)
    before = tk.launches["sample_contract"]
    got = tk.sample_contract(*ops, B=B)
    again = tk.sample_contract(*ops, B=B)
    assert tk.launches["sample_contract"] - before == 2
    tot, drop_x, nxe, Ct, Zt, Ut = ops
    X = tot if drop_x is None else tot - drop_x
    d = lambda t: None if t is None else t.double()
    a = lambda t: None if t is None else t.double().abs()
    want = tk.sample_contract_plain(X.double(), None, d(nxe), d(Ct), d(Zt),
                                    d(Ut), B)
    mags = tk.sample_contract_plain(X.double().abs(), None, a(nxe), a(Ct),
                                    a(Zt), a(Ut), B)
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    E = E_geno + num_nxe
    shapes = [(E, E), (E, ncov, B), (E, ncov, B), (E,), (E,)]
    for name, g, g2, w, m, shape in zip(("G1", "P", "R", "zd", "ud"), got,
                                        again, want, mags, shapes):
        if w is None:
            assert g is None and ncov == 0, name
            continue
        assert g.dtype == torch.float64 and g.shape == shape, name
        assert torch.equal(g, g2), name
        if g.numel():
            err = ((g - w).abs() / m.clamp_min(1e-300)).max().item()
            assert err <= tol, (name, err)
    assert torch.equal(got[0], got[0].T)


@pytest.mark.cuda
@pytest.mark.parametrize("E,ncov,f64,want", [
    # GENIE G+GxE+NxE, 2 environments, k = 10, f32: 7 x 7 X tiles (28 of
    # the upper triangle), [C | z | u] in 2 tiles, two tiles a thread
    (26, 4, False, dict(na=7, nk=2, ntiles=56, tpt=2, tg=56, nchunks=49,
                        ncs=128)),
    # RHE k = 50, 8 bins: 11 tiles, one a thread
    (8, 4, False, dict(na=2, nk=2, ntiles=11, tpt=1, tg=11, nchunks=49,
                       ncs=256)),
    # float64 takes one tile a thread, so GENIE's 56 take two groups
    (26, 4, True, dict(ntiles=56, tpt=1, tg=32, ncs=64)),
    # E = 40: 95 tiles, two groups of 64 in f32
    (40, 4, False, dict(na=10, nk=2, ntiles=95, tpt=2, tg=64)),
    # one row, no covariates: X x X and X x z
    (1, 0, False, dict(na=1, nk=1, ntiles=2, tpt=1, tg=2)),
])
def test_sample_contract_plan(cuda_device, E, ncov, f64, want):
    """The kernel's partition as the built library computes it; a block
    past the card's shared memory is refused before any launch."""
    plan = tk.sample_contract_plan(E, ncov, 100352, f64)
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        tk.sample_contract_plan(700, 4, 100352, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", ["rhe", "genie"])
def test_cuda_sample_contract_once_a_sample(cuda_device, dataset, model,
                                            dtype):
    """Every estimate launches the pass-2 kernel once a jackknife sample,
    J + 1 times, float64 (mm_mode exact) too."""
    before = tk.launches["sample_contract"]
    eng = run_engine(dataset, model, "cuda", dtype=dtype)
    assert tk.launches["sample_contract"] - before == eng.J + 1


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


def make_engine(dataset, model, device, **cfg):
    """An engine on the module's dataset (GENIE: G+GxE+NxE, two
    environments)."""
    from pyrhe_tpu_torch.core.data import load_dataset
    from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig

    prefix, annot, cov, env = dataset
    data = load_dataset(prefix, annot_file=annot,
                        pheno_file=prefix + ".pheno", cov_file=cov,
                        env_file=env if model == "genie" else None,
                        num_random_vec=6, seed=7)
    return Engine(data, ModelSpec.build(model, "G+GxE+NxE", data.num_env),
                  RunConfig(num_random_vec=6, num_jack=6, seed=7,
                            device=device, **cfg))


def run_engine(dataset, model, device, **cfg):
    """One engine run on the module's dataset."""
    eng = make_engine(dataset, model, device, **cfg)
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


def crash_at(eng, phase_at):
    """Make eng's checkpoint raise at the commit of (phase, next_j)."""
    real = eng._ckpt.commit

    def commit(phase, next_j):
        if (phase, next_j) == phase_at:
            raise RuntimeError("simulated crash")
        real(phase, next_j)

    eng._ckpt.commit = commit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,cfg,phase_at", [
    ("rhe", dict(streaming=True), ("precompute", 3)),   # acc kernels
    ("rhe_dom", dict(cache_blocks=2), ("assemble", 4)),  # hybrid pass 2
    ("genie", dict(streaming=True), ("assemble", 2)),
])
def test_cuda_checkpoint_resume_bitwise(cuda_device, dataset, tmp_path,
                                        dtype, model, cfg, phase_at):
    """A checkpointed run on the card crashed at one commit and resumed in
    a new engine: bitwise the uninterrupted run; then a done-resume reads
    no block."""
    base = run_engine(dataset, model, "cuda", dtype=dtype, **cfg)
    ck = str(tmp_path / "ck")
    eng = make_engine(dataset, model, "cuda", dtype=dtype,
                      checkpoint_dir=ck, **cfg)
    crash_at(eng, phase_at)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    for _ in range(2):
        eng = run_engine(dataset, model, "cuda", dtype=dtype,
                         checkpoint_dir=ck, **cfg)
        np.testing.assert_array_equal(eng.T_all, base.T_all)
        np.testing.assert_array_equal(eng.q_all, base.q_all)
    assert "pass1_s" not in eng.phase_times      # done: no pass ran


@pytest.mark.cuda
def test_cuda_sweep_merged_equals_solo(cuda_device, dataset, tmp_path):
    """The phenotype sweep on the card (float32, split2): two complete
    files merge into one pass whose wider gp stage-1 operand gives each
    trait the bits of its file run alone (sigma^2, SE, h2, ...); a file
    with NA rows runs alone; streaming == cached bitwise."""
    import shutil

    from pyrhe_tpu_torch.io import synth
    from pyrhe_tpu_torch.io.readers import read_annot
    from pyrhe_tpu_torch.sweep_phenotypes import build_parser, run_sweep

    prefix, annot, cov, _ = dataset
    d = tmp_path / "phenos"
    d.mkdir()
    shutil.copy(prefix + ".pheno", d / "a.pheno")
    synth.simulate_pheno_file(str(d / "b"), prefix, [0.05] * 8,
                              read_annot(annot)[1], seed=21)
    with open(d / "a.pheno") as f:
        lines = f.read().splitlines()
    with open(d / "c.pheno", "w") as f:
        for i, ln in enumerate(lines):
            cols = ln.split()
            f.write((" ".join(cols[:2] + ["NA"]) if i in (3, 50) else ln)
                    + "\n")

    def sweep(out, *extra):
        return run_sweep(build_parser().parse_args([
            "-g", prefix, "-annot", annot, "-c", cov, "--pheno_glob",
            str(d / "*.pheno"), "-o", str(tmp_path / out), "-k", "6",
            "-jn", "6", "--seed", "7", "--device", "cuda", *extra]))

    merged, solo = sweep("merged"), sweep("solo", "--no_merge")
    streamed = sweep("streaming", "--streaming")
    assert set(merged) == set(solo) == set(streamed) == {"a", "b", "c"}
    for key in merged:
        for field, value in merged[key].items():
            if field != "runtime":
                assert value == solo[key][field], f"{key}/{field}"
                assert value == streamed[key][field], f"{key}/{field}"


@pytest.fixture(scope="module")
def nccl_world1():
    """An NCCL process group of one rank in this process."""
    import os
    import socket

    from pyrhe_tpu_torch.parallel import distributed
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run: python -m pytest "
                    "--noconftest tests/test_torch_cuda.py")
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                             "LOCAL_RANK", "MASTER_ADDR",
                                             "MASTER_PORT")}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        distributed.initialize("cuda", timeout_s=120)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield
    distributed.destroy()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_cuda_run_sharded_nccl_world1(cuda_device, nccl_world1, dataset,
                                      tmp_path, model):
    """Engine.run_sharded() through an NCCL group of one rank, cached,
    streaming and hybrid: bitwise the sequential engine on the card; a
    sharded checkpointed run crashed mid pass 1 resumes bitwise."""
    import torch.distributed as dist
    assert dist.get_backend() == "nccl"
    for cfg in (dict(), dict(streaming=True), dict(cache_blocks=2)):
        base = run_engine(dataset, model, "cuda", **cfg)
        eng = make_engine(dataset, model, "cuda", **cfg)
        eng.run_sharded()
        np.testing.assert_array_equal(eng.T_all, base.T_all)
        np.testing.assert_array_equal(eng.q_all, base.q_all)
    from pyrhe_tpu_torch.core.checkpoint import Checkpoint
    ck = str(tmp_path / "ck")
    real = Checkpoint.commit

    def commit(self, phase, next_j):
        if (phase, next_j) == ("precompute", 3):
            raise RuntimeError("simulated crash")
        real(self, phase, next_j)

    Checkpoint.commit = commit
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            make_engine(dataset, model, "cuda", streaming=True,
                        checkpoint_dir=ck).run_sharded()
    finally:
        Checkpoint.commit = real
    eng = make_engine(dataset, model, "cuda", streaming=True,
                      checkpoint_dir=ck)
    eng.run_sharded()
    np.testing.assert_array_equal(eng.T_all, base.T_all)
    np.testing.assert_array_equal(eng.q_all, base.q_all)


@pytest.mark.cuda
def test_cuda_matvec_acc_equals_standard(cuda_device):
    """pyrhe_tpu_torch.bench.matvec's body through the kernels at a small
    size: the streaming pass-1 body's totals bitwise equal to the cached
    body's, split2 and bf16, with GxE and with dominance components; then
    one timed configuration, whose rate is positive and below the peak."""
    from pyrhe_tpu_torch.bench import matvec
    for mode in ("split2", "bf16"):
        for num_env, dom, acc in ((1, False, "ytg_acc_matmul"),
                                  (0, True, "ytg_acc2_matmul")):
            case = matvec.make_case(5000, 256, 4, 10, use_cov=True,
                                    num_env=num_env, dom=dom,
                                    dev=cuda_device)
            blocks = matvec.make_blocks(3, 256, case.P.shape[0],
                                        cuda_device)
            before = dict(tk.launches)
            assert matvec.acc_equals_standard(case, blocks, mode)
            assert tk.launches[acc] > before[acc]
            assert tk.launches["gp_matmul"] > before["gp_matmul"]
    out = matvec.bench_config(8192, 256, 1, 10, 2, dev=cuda_device, reps=2)
    assert out["acc_equals_standard"] and out["value"] > 0
    assert 0 < out["mfu_pct"] < 100 and out["device_busy_pct"] > 0
