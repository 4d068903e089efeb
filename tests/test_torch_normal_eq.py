"""PyTorch port, core/normal_eq.py: assemble_Tq_core in float64 against the
JAX package's on the same numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrhe_tpu.core.normal_eq import assemble_Tq_core as jax_assemble

from pyrhe_tpu_torch.core.normal_eq import assemble_Tq_core

torch.set_num_threads(2)


@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_assemble_Tq_matches_jax_float64(cov, stochastic):
    rng = np.random.default_rng(int(cov) * 2 + int(stochastic))
    E, N, B, T, ncov = 5, 700, 4, 2, 3
    b2 = 2 * B if cov else B
    XXP = rng.normal(size=(E, N, b2))
    yXXy = rng.normal(size=(E, T))
    M = np.array([40, 0, 13, 7, 25])            # one empty estimate
    Z = rng.normal(size=(N, B))
    C = rng.normal(size=(N, ncov)) if cov else None
    Q = np.linalg.pinv(C.T @ C) if cov else None
    Uzb = C @ (Q @ (C.T @ Z)) if cov else np.zeros((N, B))
    q_last = rng.normal(size=T) ** 2
    stoch = np.array([False, False, True, True, False]) & stochastic
    kw = dict(num_random_vec=B, n_indiv=N - 5, n_cov=ncov if cov else 0)

    j = lambda x: None if x is None else jnp.asarray(x)
    T0, q0 = jax_assemble(j(XXP), j(yXXy), j(M), j(Z), j(Uzb), j(C), j(Q),
                          j(q_last), j(stoch), **kw)
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
    T1, q1 = assemble_Tq_core(t(XXP), t(yXXy), t(M), t(Z), t(Uzb), t(C),
                              t(Q), t(q_last), t(stoch), **kw)
    assert T1.dtype == torch.float64 and T1.shape == (E + 1, E + 1)
    np.testing.assert_allclose(T1.numpy(), np.asarray(T0), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(q1.numpy(), np.asarray(q0), rtol=1e-10,
                               atol=0)
    assert np.all(T1.numpy()[1, :E] == 0) and np.all(q1.numpy()[1] == 0)
