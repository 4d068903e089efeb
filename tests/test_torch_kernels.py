"""PyTorch port, ops/kernels.py: the plain versions of gp, ytg (g and g²),
ytg_acc and ytg_acc2 against the JAX package's Pallas kernels (interpret
mode, f32, clean int32 words), the split2 forms against a float64 dense
product, ytg_acc / ytg_acc2 against ytg plus the transform (bitwise), and
the shared layout helpers. The CUDA kernels themselves are checked against
these plain versions on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrhe_tpu.io.bed import clean_packed, encode_dosage
from pyrhe_tpu.ops import kernels as jk

from pyrhe_tpu_torch.ops import kernels as tk
from pyrhe_tpu_torch.ops.moments import _hilo

torch.set_num_threads(2)

TM, TN = 256, 2048          # reference tile (word mode needs tn % 2048 == 0)
RTOL = 1e-5                 # f32 summation order only


def make_block(m=300, n=700, seed=0):
    """Cleaned (m_pad, n_pad/16) words of a random block with missing
    codes rewritten by the fills, and the natural-order dosages."""
    rng = np.random.default_rng(seed)
    dos = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    dos[rng.random((m, n)) < 0.05] = 255
    fill = rng.integers(0, 3, size=m).astype(np.float64)
    m_pad, n_pad = tk.pad_to(m, 512), tk.pad_to(n, TN)
    clean = np.zeros((m_pad, n_pad // 4), np.uint8)
    clean_packed(encode_dosage(dos), fill, out=clean[:m])
    g = np.where(dos == 255, fill[:, None], dos).astype(np.float64)
    perm = tk.plane_permutation(n_pad)
    return clean.view(np.int32), g, perm, m, n, m_pad, n_pad


def jax_kw():
    return dict(tm=TM, tn=TN, dtype=jnp.float32, interpret=True, clean=True,
                word=True)


def assert_close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_layout_helpers_match_reference():
    for n_pad in (2048, 6144):
        np.testing.assert_array_equal(tk.plane_permutation(n_pad),
                                      jk.plane_permutation(n_pad, 2048, 16))
    for x, mult in ((1, 32), (1000, 32), (100352, 2048), (0, 7)):
        assert tk.pad_to(x, mult) == jk.pad_to(x, mult)


def test_decode_words_matches_dense():
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=1)
    dense = tk.decode_words(torch.from_numpy(words)).numpy()
    expect = np.zeros((m_pad, n_pad))
    expect[:m, :n] = g
    np.testing.assert_array_equal(dense, expect[:, perm])


@pytest.mark.parametrize("W", [6, 23])
def test_gp_plain_matches_pallas(W):
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=2)
    rng = np.random.default_rng(3)
    C = rng.normal(size=(n_pad, W)).astype(np.float32)
    ref = jk.gp_matmul(jnp.asarray(words), jnp.zeros((m_pad, 1)),
                       jnp.asarray(C), **jax_kw())
    got = tk.gp_matmul(torch.from_numpy(words), torch.from_numpy(C))
    assert got.shape == (m_pad, W) and got.dtype == torch.float32
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("Q", [8, 40])
def test_ytg_plain_matches_pallas(Q):
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=4)
    rng = np.random.default_rng(5)
    Yt = rng.normal(size=(Q, m_pad)).astype(np.float32)
    Yt[:, m:] = 0.0
    ref = jk.ytg_matmul(jnp.asarray(words), jnp.zeros((m_pad, 1)),
                        jnp.asarray(Yt), **jax_kw())
    got = tk.ytg_matmul(torch.from_numpy(words), torch.from_numpy(Yt))
    assert got.shape == (Q, n_pad)
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("split", [False, True])
def test_ytg_acc_plain_matches_pallas(split):
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=6)
    rng = np.random.default_rng(7)
    Q = 12
    Yt = rng.normal(size=(2 * Q if split else Q, m_pad)).astype(np.float32)
    Yt[:, m:] = 0.0
    rank1 = rng.normal(size=(Q, 1)).astype(np.float32)
    scale = rng.normal(size=(1, n_pad)).astype(np.float32)
    mask = (perm < n).astype(np.float32)[None, :]
    tot = rng.normal(size=(Q, n_pad)).astype(np.float32)
    ref = jk.ytg_acc_matmul(
        jnp.asarray(words), jnp.zeros((m_pad, 1)), jnp.asarray(Yt),
        jnp.asarray(rank1), jnp.asarray(scale), jnp.asarray(mask),
        jnp.asarray(tot), split=split, **jax_kw())
    t = torch.from_numpy(tot.copy())
    got = tk.ytg_acc_matmul(torch.from_numpy(words), torch.from_numpy(Yt),
                            torch.from_numpy(rank1), torch.from_numpy(scale),
                            torch.from_numpy(mask), t, split=split)
    assert got is t                              # updated in place
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("kernel", ["gp", "ytg"])
def test_square_plain_matches_pallas(kernel):
    """square=True (dosage², RHE-DOM): the decode against the dense g², and
    each product against the Pallas kernel's square variant."""
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=12)
    rng = np.random.default_rng(13)
    w = torch.from_numpy(words)
    dense = np.zeros((m_pad, n_pad))
    dense[:m, :n] = g * g
    np.testing.assert_array_equal(tk.decode_words(w, square=True).numpy(),
                                  dense[:, perm])
    fill = jnp.zeros((m_pad, 1))
    if kernel == "gp":
        C = rng.normal(size=(n_pad, 21)).astype(np.float32)
        ref = jk.gp_matmul(jnp.asarray(words), fill, jnp.asarray(C),
                           square=True, **jax_kw())
        got = tk.gp_matmul(w, torch.from_numpy(C), square=True)
    else:
        Yt = rng.normal(size=(24, m_pad)).astype(np.float32)
        Yt[:, m:] = 0.0
        ref = jk.ytg_matmul(jnp.asarray(words), fill, jnp.asarray(Yt),
                            square=True, **jax_kw())
        got = tk.ytg_matmul(w, torch.from_numpy(Yt), square=True)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_close(got.numpy(), ref)


def _acc2_operands(seed, Q, split, m, m_pad, n_pad):
    rng = np.random.default_rng(seed)
    Qr = 2 * Q if split else Q
    Yt1, Yt2 = (rng.normal(size=(Qr, m_pad)).astype(np.float32)
                for _ in range(2))
    Yt1[:, m:] = Yt2[:, m:] = 0.0
    rank1 = rng.normal(size=(Q, 1)).astype(np.float32)
    tot = rng.normal(size=(Q, n_pad)).astype(np.float32)
    return Yt1, Yt2, rank1, tot


@pytest.mark.parametrize("split", [False, True])
def test_ytg_acc2_plain_matches_pallas(split):
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=14)
    Q = 9
    Yt1, Yt2, rank1, tot = _acc2_operands(15, Q, split, m, m_pad, n_pad)
    mask = (perm < n).astype(np.float32)[None, :]
    ref = jk.ytg_acc2_matmul(
        jnp.asarray(words), jnp.zeros((m_pad, 1)), jnp.asarray(Yt1),
        jnp.asarray(Yt2), jnp.asarray(rank1), jnp.asarray(mask),
        jnp.asarray(tot), split=split, **jax_kw())
    t = torch.from_numpy(tot.copy())
    got = tk.ytg_acc2_matmul(torch.from_numpy(words), torch.from_numpy(Yt1),
                             torch.from_numpy(Yt2), torch.from_numpy(rank1),
                             torch.from_numpy(mask), t, split=split)
    assert got is t                              # updated in place
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("split", [False, True])
def test_ytg_acc2_equals_two_ytg_plus_transform(split):
    """The dominance aliased-totals contract (tests/test_kernels.py
    test_ytg_acc2_matmul): bitwise equal to ytg over g and square ytg over
    g², each summed over its hi/lo halves, then (XXG + XXG2) − rank1,
    × mask, tot +."""
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=16)
    Q = 10
    Yt1, Yt2, rank1, tot0 = (torch.from_numpy(x) for x in _acc2_operands(
        17, Q, False, m, m_pad, n_pad))
    w = torch.from_numpy(words)
    Y1, Y2 = ((_hilo(Yt1, 0).contiguous(), _hilo(Yt2, 0).contiguous())
              if split else (Yt1, Yt2))
    mask = torch.tensor((perm < n)[None, :], dtype=torch.float32)
    got = tk.ytg_acc2_matmul(w, Y1, Y2, rank1, mask, tot0.clone(),
                             split=split)
    a1 = tk.sum_halves(tk.ytg_matmul(w, Y1), split)
    a2 = tk.sum_halves(tk.ytg_matmul(w, Y2, square=True), split)
    assert torch.equal(got, tot0 + ((a1 + a2) - rank1) * mask)


@pytest.mark.parametrize("kernel", ["gp", "ytg"])
def test_split2_matches_dense_float64(kernel):
    """bf16 hi/lo halves of the probe side (the card's mode), summed after
    the product: within the split2 envelope of a float64 dense product
    (tolerances of tests/test_tpu_smoke.py)."""
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=8)
    rng = np.random.default_rng(9)
    w = torch.from_numpy(words)
    gd = np.zeros((m_pad, n_pad))
    gd[:m, :n] = g
    gd = gd[:, perm]
    if kernel == "gp":
        C = rng.normal(size=(n_pad, 8))
        out = tk.gp_matmul(w, _hilo(torch.tensor(C, dtype=torch.float32),
                                    1).contiguous())
        got, expect = (out[:, :8] + out[:, 8:]).numpy(), gd @ C
    else:
        Yt = rng.normal(size=(8, m_pad))
        Yt[:, m:] = 0.0
        out = tk.ytg_matmul(w, _hilo(torch.tensor(Yt, dtype=torch.float32),
                                     0).contiguous())
        got, expect = (out[:8] + out[8:]).numpy(), Yt @ gd
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("split", [False, True])
def test_ytg_acc_equals_ytg_plus_transform(split):
    """The aliased-totals contract: bitwise equal to ytg followed by the
    materializing path's tensor ops, for additive (scale 1) and GxE
    (env scale) epilogues."""
    words, g, perm, m, n, m_pad, n_pad = make_block(seed=10)
    rng = np.random.default_rng(11)
    Q = 10
    w = torch.from_numpy(words)
    Yt = torch.tensor(rng.normal(size=(Q, m_pad)), dtype=torch.float32)
    Yop = _hilo(Yt, 0).contiguous() if split else Yt
    rank1 = torch.tensor(rng.normal(size=(Q, 1)), dtype=torch.float32)
    mask = torch.tensor((perm < n)[None, :], dtype=torch.float32)
    for scale in (torch.ones(1, n_pad),
                  torch.tensor(rng.normal(size=(1, n_pad)),
                               dtype=torch.float32)):
        tot0 = torch.tensor(rng.normal(size=(Q, n_pad)), dtype=torch.float32)
        got = tk.ytg_acc_matmul(w, Yop, rank1, scale, mask, tot0.clone(),
                                split=split)
        a = tk.ytg_matmul(w, Yop)
        if split:
            a = a[:Q] + a[Q:]
        assert torch.equal(got, tot0 + ((a - rank1) * scale) * mask)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "contig",
                                 "acc_shape", "acc2_shape", "acc2_dtype"])
def test_wrappers_check_their_contract(bad):
    w = torch.zeros((32, 128), dtype=torch.int32)
    C = torch.zeros((2048, 4))
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            tk.gp_matmul(w.to(torch.int64), C)
        elif bad == "shape":
            tk.gp_matmul(w, C[:1024])
        elif bad == "rows":
            tk.ytg_matmul(torch.zeros((48, 128), dtype=torch.int32),
                          torch.zeros((4, 48)))
        elif bad == "contig":
            tk.ytg_matmul(w, torch.zeros((32, 4)).T)
        elif bad == "acc_shape":
            tk.ytg_acc_matmul(w, torch.zeros((4, 32)), torch.zeros((4, 1)),
                              torch.ones((1, 2048)), torch.ones((1, 2048)),
                              torch.zeros((4, 2048)), split=True)
        elif bad == "acc2_shape":            # Yt2 rows differ from Yt1's
            tk.ytg_acc2_matmul(w, torch.zeros((4, 32)), torch.zeros((2, 32)),
                               torch.zeros((2, 1)), torch.ones((1, 2048)),
                               torch.zeros((2, 2048)), split=True)
        else:                                # Yt2 dtype differs from Yt1's
            tk.ytg_acc2_matmul(w, torch.zeros((4, 32)),
                               torch.zeros((4, 32), dtype=torch.bfloat16),
                               torch.zeros((4, 1)), torch.ones((1, 2048)),
                               torch.zeros((4, 2048)), split=False)


@pytest.mark.parametrize("m_pad,n_pad", [
    (32, 2048), (1024, 100352), (320, 10240), (1024, 500 * 1024),
    (96, 2048 * 700), (4096, 2048 * 3),
])
def test_gp_splits_cover_every_word_once(m_pad, n_pad):
    """gp_matmul's split-K partition: contiguous ranges of whole periods
    (128 words each), none empty, that cover every word of a row once."""
    per, S = tk.gp_splits(m_pad, n_pad)
    periods = n_pad // tk.TN
    assert per >= 1 and 1 <= S <= periods
    covered = np.zeros(n_pad // tk.PLANES, int)
    for s in range(S):               # the kernel's range for blockIdx.z = s
        p0, p1 = s * per, min(periods, (s + 1) * per)
        assert p1 > p0
        covered[p0 * 128:p1 * 128] += 1
    assert (covered == 1).all()
    row_tiles = -(-m_pad // tk.GP_ROWS)
    assert S == periods or row_tiles * S <= tk.GP_BLOCKS


def test_gp_splits_depend_on_shapes_alone(monkeypatch):
    """S and the workspace are functions of (m_pad, n_pad, W): the same on
    every call, and computed without asking torch about any card."""
    def no_card(*a, **k):
        raise AssertionError("gp_splits asked about the card")

    for fn in ("is_available", "device_count", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, fn, no_card)
    first = [tk.gp_splits(1024, n) for n in (2048, 100352, 512000)]
    assert [tk.gp_splits(1024, n) for n in (2048, 100352, 512000)] == first
    assert first == [(1, 1), (1, 49), (4, 63)]
    # the phase-4 block: 8 row tiles x 49 one-period splits
    assert tk.gp_workspace_shape(1024, 100352, 44) == (49, 1024, 44)
    assert tk.gp_workspace_shape(32, 2048, 44) == (0,)     # S == 1: none
    assert tk.gp_workspace_shape(320, 10240, 61) == (5, 320, 61)
