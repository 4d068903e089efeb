"""The JAX package's Engine on a test dataset: the reference that the
port's checkpoint and sharding tests hold T and q against. Tests import it
inside their bodies, so the two-rank worker of test_torch_sharded.py (that
file run as a script) never imports jax."""
from pyrhe_tpu.core.data import load_dataset
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig


def run_jax(prefix, model: str, J: int, data_kw: dict,
            genie_model: str = "G+GxE+NxE", **cfg):
    """A finished JAX Engine run, float64 unless cfg says otherwise, on the
    .bed at prefix; data_kw are load_dataset's arguments, num_random_vec
    and seed among them."""
    data = load_dataset(prefix, **data_kw)
    eng = Engine(data, ModelSpec.build(model, genie_model, data.num_env),
                 RunConfig(num_random_vec=data_kw["num_random_vec"],
                           num_jack=J, seed=data_kw["seed"],
                           **dict(dict(dtype="float64"), **cfg)))
    eng.run_precompute_and_assemble()
    return eng
