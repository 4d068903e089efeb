"""PyTorch port, core/normal_eq.py: assemble_Tq_core in float64 against the
JAX package's on the same numpy-seeded inputs, through the plain version of
the pass-2 kernel (ops/kernels.sample_contract on CPU tensors): the stats
as the engine holds them (totals, a left-out block, NxE rows) against the
reference's leave-one-out XXP, and covariate-space G2 / G3 against the
reference's projected stats."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrhe_tpu.core.normal_eq import assemble_Tq_core as jax_assemble

from pyrhe_tpu_torch.core.normal_eq import assemble_Tq_core
from pyrhe_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)

N, T = 300, 2


def make_case(E, B, ncov, rows, seed, stressed=0.0):
    """Inputs of one sample: tot, drop, nxe (the engine's), the reference's
    X = cat(tot - drop, nxe), and the probes, covariates and masks. rows:
    "total" (the full sample: no drop, no NxE rows) or "drop_nxe" (a block
    left out, up to two NxE rows). stressed > 0: every stats row is a
    vector of span(C) (the same for XXz and XXUz) plus `stressed` times
    noise, so G1 + G3 - 2 G2 cancels."""
    rng = np.random.default_rng(seed)
    num_nxe = min(2, E - 1) if rows == "drop_nxe" else 0
    E_geno = E - num_nxe
    b2 = 2 * B if ncov else B

    def stats(*lead):
        if not stressed:
            return rng.normal(size=(*lead, b2, N))
        span_part = np.einsum("...bk,nk->...bn",
                              rng.normal(size=(*lead, B, ncov)), C)
        return (np.concatenate([span_part, span_part], axis=-2)
                + stressed * rng.normal(size=(*lead, b2, N)))

    C = rng.normal(size=(N, ncov)) if ncov else None
    tot = stats(E_geno)
    nxe = stats(num_nxe) if num_nxe else None
    drop = 0.1 * stats(E_geno) if rows == "drop_nxe" else None
    X = tot - drop if drop is not None else tot
    if nxe is not None:
        X = np.concatenate([X, nxe])
    Z = rng.normal(size=(N, B))
    Q = np.linalg.pinv(C.T @ C) if ncov else None
    Uzb = C @ (Q @ (C.T @ Z)) if ncov else np.zeros((N, B))
    M = rng.integers(1, 50, size=E)
    if E > 1:
        M[1] = 0                                  # one empty estimate
    stoch = rng.random(E) < 0.5
    return dict(tot=tot, drop=drop, nxe=nxe, X=X, yXXy=rng.normal(size=(E, T)),
                M=M, Z=Z, Uzb=Uzb, C=C, Q=Q,
                q_last=rng.normal(size=T) ** 2, stoch=stoch,
                kw=dict(num_random_vec=B, n_indiv=N - 5, n_cov=ncov))


def both(c):
    """(T, q) of the JAX package and of the port on the case's inputs."""
    j = lambda x: None if x is None else jnp.asarray(x)
    T0, q0 = jax_assemble(j(c["X"].transpose(0, 2, 1)), j(c["yXXy"]),
                          j(c["M"]), j(c["Z"]), j(c["Uzb"]), j(c["C"]),
                          j(c["Q"]), j(c["q_last"]), j(c["stoch"]),
                          **c["kw"])
    t = lambda x: None if x is None else torch.from_numpy(
        np.ascontiguousarray(x))
    ncov = c["kw"]["n_cov"]
    T1, q1 = assemble_Tq_core(
        t(c["tot"]), t(c["drop"]), t(c["nxe"]), t(c["yXXy"]), t(c["M"]),
        t(c["Z"].T), t(c["Uzb"].T) if ncov else None,
        None if c["C"] is None else t(c["C"].T), t(c["Q"]), t(c["q_last"]),
        t(c["stoch"]), **c["kw"])
    return (T1, q1), (np.asarray(T0), np.asarray(q0))


@pytest.mark.parametrize("rows", ["total", "drop_nxe"])
@pytest.mark.parametrize("ncov", [0, 1, 3])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("E", [1, 5, 26])
def test_assemble_Tq_matches_jax_float64(E, B, ncov, rows):
    c = make_case(E, B, ncov, rows, seed=E * 100 + B * 10 + ncov)
    (T1, q1), (T0, q0) = both(c)
    assert T1.dtype == torch.float64 and T1.shape == (E + 1, E + 1)
    np.testing.assert_allclose(T1.numpy(), T0, rtol=1e-10, atol=0)
    np.testing.assert_allclose(q1.numpy(), q0, rtol=1e-10, atol=0)
    if E > 1:
        assert np.all(T1.numpy()[1, :E] == 0) and np.all(q1.numpy()[1] == 0)


@pytest.mark.parametrize("rows", ["total", "drop_nxe"])
def test_assemble_Tq_stressed_covariates(rows):
    """Stats mostly in span(C): G1 + G3 - 2 G2 cancels by more than 100x
    (about 900x here), and T from covariate space still matches the
    reference's projected stats at rtol 1e-10."""
    E, B, ncov = 5, 4, 3
    c = make_case(E, B, ncov, rows, seed=7, stressed=3e-2)
    X, C, Q = c["X"], c["C"], c["Q"]
    XXz, XXUz = X[:, :B], X[:, B:]
    UXXz = np.einsum("nc,cd,kd,ebk->ebn", C, Q, C, XXz)
    G1 = np.einsum("ebn,fbn->ef", XXz, XXz)
    raw = (G1 + np.einsum("ebn,fbn->ef", XXUz, UXXz)
           - 2 * np.einsum("ebn,fbn->ef", UXXz, XXz))
    assert np.abs(G1).max() > 100 * np.abs(raw).max()
    (T1, q1), (T0, q0) = both(c)
    np.testing.assert_allclose(T1.numpy(), T0, rtol=1e-10, atol=0)
    np.testing.assert_allclose(q1.numpy(), q0, rtol=1e-10, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sample_contract_plain_definitions(dtype):
    """The plain version's five outputs against their definitions in
    float64 NumPy (float32 stats: within float32 summation error), and
    float64 out in either dtype."""
    c = make_case(6, 3, 2, "drop_nxe", seed=3)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    B = 3
    G1, P, R, zd, ud = tk.sample_contract(
        t(c["tot"]), t(c["drop"]), t(c["nxe"]), t(c["C"].T), t(c["Z"].T),
        t(c["Uzb"].T), B=B)
    X = torch.from_numpy(c["X"]).to(dtype).double().numpy()
    want = (np.einsum("ebn,fbn->ef", X[:, :B], X[:, :B]),
            np.einsum("nk,ebn->ekb", c["C"], X[:, :B]),
            np.einsum("nk,ebn->ekb", c["C"], X[:, B:]),
            np.einsum("ebn,nb->e", X[:, :B], c["Z"]),
            np.einsum("ebn,nb->e", X[:, :B], c["Uzb"]))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for got, ref in zip((G1, P, R, zd, ud), want):
        assert got.dtype == torch.float64 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
    # no covariates: b2 = B, P and R empty, no ud
    tot = t(c["tot"][:, :B])
    G1, P, R, zd, ud = tk.sample_contract(tot, None, None, None,
                                          t(c["Z"].T), None, B=B)
    assert P.shape == R.shape == (4, 0, B) and ud is None
    ref = np.einsum("ebn,fbn->ef", tot.double().numpy(), tot.double().numpy())
    np.testing.assert_allclose(G1.numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_sample_contract_checks_its_arguments():
    z = torch.zeros
    tot, Zt = z(3, 4, 64), z(2, 64)
    with pytest.raises(ValueError, match="b2"):
        tk.sample_contract(tot, None, None, None, Zt, None, B=2)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sample_contract(z(3, 64, 2).transpose(1, 2), None, None, None,
                           Zt, None, B=2)
    with pytest.raises(ValueError, match="drop shape"):
        tk.sample_contract(z(3, 2, 64), z(2, 2, 64), None, None, Zt, None,
                           B=2)
    with pytest.raises(TypeError, match="Zt is torch.float64"):
        tk.sample_contract(z(3, 2, 64), None, None, None,
                           Zt.double(), None, B=2)
