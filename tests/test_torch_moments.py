"""PyTorch port, ops/moments.py: the standard and aliased (acc) block
cores and the acc scan against the JAX package's (Pallas in interpret mode,
kernel dtype f32), on the same numpy-seeded inputs, for additive, GxE and
dominance components, and the port's own acc == standard bit-identity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrhe_tpu.io.bed import clean_packed, encode_dosage
from pyrhe_tpu.ops import moments as jm

from pyrhe_tpu_torch.ops import kernels as tk
from pyrhe_tpu_torch.ops import moments as tm

torch.set_num_threads(2)

RTOL = 1e-5
K, B, T = 3, 4, 2
JAX_KW = dict(dtype=jnp.float32, kernel_dtype=jnp.float32, mm_split=False,
              clean=True, interpret=True, tm=256, tn=2048, word=True)


def make_inputs(seed, m=300, n=700, cov=True):
    """One block (words, annot) plus plane-permuted probes, env and a
    validity mask that also drops a few real individuals."""
    rng = np.random.default_rng(seed)
    dos = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    dos[rng.random((m, n)) < 0.03] = 255
    m_pad, n_pad = tk.pad_to(m, 512), tk.pad_to(n, 2048)
    clean = np.zeros((m_pad, n_pad // 4), np.uint8)
    clean_packed(encode_dosage(dos), rng.integers(0, 3, size=m).astype(
        np.float64), out=clean[:m])
    perm = tk.plane_permutation(n_pad)
    keep = np.zeros(n_pad, bool)
    keep[:n] = True
    keep[[0, 17, n - 1]] = False
    b2 = B * (2 if cov else 1)
    P = rng.normal(size=(n_pad, b2 + T)) * keep[:, None]
    env = (rng.random((n_pad, 1)) < 0.5) * keep[:, None]
    annot = np.zeros((m_pad, K))
    annot[np.arange(m), rng.integers(0, K, m)] = 1.0
    arrays = dict(words=clean.view(np.int32), annot=annot.astype(np.float32),
                  P=P[perm].astype(np.float32),
                  env=env[perm].astype(np.float32),
                  mask=keep[perm].astype(np.float32))
    return arrays, int(keep.sum()), b2


def as_jax(a):
    return [jnp.asarray(a[k]) for k in ("words", "annot", "P", "env",
                                        "mask")]


def as_torch(a):
    return [torch.from_numpy(np.ascontiguousarray(a[k]))
            for k in ("words", "annot", "P", "env", "mask")]


def assert_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


COMPONENTS = [(("add", None),), (("add", None), ("add", 0)),
              (("add", None), ("dom", None))]


@pytest.mark.parametrize("components", COMPONENTS)
@pytest.mark.parametrize("cov", [False, True])
def test_block_stats_core_matches_jax(components, cov):
    a, n_indiv, b2 = make_inputs(1, cov=cov)
    w, annot, P, env, mask = as_jax(a)
    X0, y0, M0 = jm.block_stats_pallas(
        w, jnp.zeros(w.shape[0]), annot, P, env, mask, n_indiv=n_indiv,
        components=components, b2=b2, **JAX_KW)
    w, annot, P, env, mask = as_torch(a)
    X1, y1, M1 = tm.block_stats_pallas_core(
        w, annot, P, env, mask, n_indiv=n_indiv, components=components,
        b2=b2, mode="f32")
    assert X1.shape == X0.shape and y1.shape == y0.shape
    assert_close(X1, X0)
    assert_close(y1, y0)
    np.testing.assert_array_equal(M1.numpy(), np.asarray(M0))


@pytest.mark.parametrize("components", COMPONENTS)
def test_block_stats_acc_core_matches_jax(components):
    _check_acc_core_matches_jax(components, cov=True)


@pytest.mark.parametrize("components", COMPONENTS)
def test_block_stats_acc_core_no_cov_matches_jax(components):
    _check_acc_core_matches_jax(components, cov=False)


def _check_acc_core_matches_jax(components, cov):
    a, n_indiv, b2 = make_inputs(2, cov=cov)
    rng = np.random.default_rng(3)
    n_pad = a["P"].shape[0]
    tots = [rng.normal(size=(K * b2, n_pad)).astype(np.float32)
            for _ in components]
    w, annot, P, env, mask = as_jax(a)
    new0, y0 = jm.block_stats_pallas_acc_core(
        w, jnp.zeros(w.shape[0]), annot, P, env, mask,
        [jnp.asarray(t) for t in tots], n_indiv=n_indiv,
        components=components, b2=b2, **JAX_KW)
    w, annot, P, env, mask = as_torch(a)
    tt = [torch.from_numpy(t.copy()) for t in tots]
    new1, y1 = tm.block_stats_pallas_acc_core(
        w, annot, P, env, mask, tt, n_indiv=n_indiv, components=components,
        b2=b2, mode="f32")
    for got, ref in zip(new1, new0):
        assert_close(got, ref)
    assert_close(y1, y0)


@pytest.mark.parametrize("mode", ["f32", "split2", "bf16"])
def test_acc_scan_equals_standard_core_bitwise(mode):
    """Streaming pass 1 (aliased totals) == cached pass 1 (standard core +
    tensor adds), bit for bit, over two blocks of different heights, in
    each kernel mode."""
    _check_acc_scan_equals_standard_core(mode, (("add", None), ("add", 0)))


@pytest.mark.parametrize("mode", ["f32", "split2", "bf16"])
def test_dom_acc_scan_equals_standard_core_bitwise(mode):
    """The same for RHE-DOM: the dominance totals ride ytg_acc2_matmul in
    the scan and two ytg_matmul calls (g, g²) in the standard core."""
    _check_acc_scan_equals_standard_core(mode, (("add", None),
                                                ("dom", None)))


def _check_acc_scan_equals_standard_core(mode, comps):
    blocks = []
    for seed, m in ((4, 300), (5, 160)):
        a, n_indiv, b2 = make_inputs(seed, m=m)
        w, annot, P, env, mask = as_torch(a)
        blocks.append((w, annot))
    kw = dict(n_indiv=n_indiv, b2=b2, mode=mode, components=comps)
    E, n_pad = len(comps) * K, P.shape[0]
    totX = torch.zeros((E, b2, n_pad))
    toty = torch.zeros((E, T))
    for w, annot in blocks:
        X, y, _ = tm.block_stats_pallas_core(w, annot, P, env, mask, **kw)
        totX = totX + X.transpose(1, 2)
        toty = toty + y
    accX, accy = tm.acc_scan_stats(iter(blocks), P, env, mask,
                                   torch.zeros((E, b2, n_pad)),
                                   torch.zeros((E, T)), K=K, **kw)
    assert torch.equal(accX, totX) and torch.equal(accy, toty)


def test_acc_scan_matches_jax():
    _check_acc_scan_matches_jax((("add", None),))


def test_dom_acc_scan_matches_jax():
    _check_acc_scan_matches_jax((("add", None), ("dom", None)))


def _check_acc_scan_matches_jax(comps):
    a, n_indiv, b2 = make_inputs(6)
    b, _, _ = make_inputs(7)
    E, n_pad = len(comps) * K, a["P"].shape[0]
    stack = lambda k: jnp.asarray(np.stack([a[k], b[k]]))
    (X0, y0) = jm.acc_scan_stats(
        (stack("words"), jnp.zeros((2, a["words"].shape[0])),
         stack("annot")), jnp.asarray(a["P"]), jnp.asarray(a["env"]),
        jnp.asarray(a["mask"]), jnp.zeros((E, n_pad, b2), jnp.float32),
        jnp.zeros((E, T), jnp.float32), K=K, components=comps,
        n_indiv=n_indiv, b2=b2, **JAX_KW)
    blocks = [(torch.from_numpy(x["words"]), torch.from_numpy(x["annot"]))
              for x in (a, b)]
    _, annot, P, env, mask = as_torch(a)
    X1, y1 = tm.acc_scan_stats(iter(blocks), P, env, mask,
                               torch.zeros((E, b2, n_pad)),
                               torch.zeros((E, T)), K=K, components=comps,
                               n_indiv=n_indiv, b2=b2, mode="f32")
    assert_close(X1.transpose(1, 2), X0)
    assert_close(y1, y0)


def test_dominance_components_raise():
    """Components no epilogue handles fail loudly in both cores (the
    reference's guard, pyrhe_tpu/ops/moments.py block_stats_pallas_acc_core):
    an env-scaled dominance component and an unknown kind."""
    a, n_indiv, b2 = make_inputs(8)
    w, annot, P, env, mask = as_torch(a)
    n_pad = P.shape[0]
    for comps in ((("add", None), ("dom", 0)), (("add", None), ("gxe", 0)),
                  (("Add", None),)):
        with pytest.raises(ValueError, match="unsupported component"):
            tm.block_stats_pallas_core(
                w, annot, P, env, mask, n_indiv=n_indiv, components=comps,
                b2=b2, mode="f32")
        with pytest.raises(ValueError, match="unsupported component"):
            tm.block_stats_pallas_acc_core(
                w, annot, P, env, mask,
                [torch.zeros((K * b2, n_pad)) for _ in comps],
                n_indiv=n_indiv, components=comps, b2=b2, mode="f32")
