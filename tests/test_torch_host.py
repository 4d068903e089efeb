"""PyTorch port, host layer: readers and load_dataset against the JAX
package's, the engine's static arrays against a JAX Engine's, the import
boundary (no jax, no pandas) and device selection."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyrhe_tpu.core.data import load_dataset as jax_load_dataset
from pyrhe_tpu.core.engine import Engine as JaxEngine
from pyrhe_tpu.core.engine import ModelSpec as JaxModelSpec
from pyrhe_tpu.core.engine import RunConfig as JaxRunConfig
from pyrhe_tpu.io import readers as jax_readers

from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import pick_device, static_arrays_from_numpy
from pyrhe_tpu_torch.io import readers
from pyrhe_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def messy_cov(tmp_path_factory):
    """Covariates with NA, -9, a non-numeric token and a categorical
    column, plus an extra blank line."""
    d = tmp_path_factory.mktemp("cov")
    rng = np.random.default_rng(0)
    rows = ["FID IID age batch score"]
    for i in range(40):
        age = f"{rng.normal(50, 10):.4f}"
        batch = str(int(rng.integers(0, 3)))
        score = f"{rng.normal():.6g}"
        if i == 3:
            age = "NA"
        if i == 7:
            score = "-9"
        if i == 11:
            batch = "abc"
        rows.append(f"{i} 1 {age} {batch} {score}")
        if i == 20:
            rows.append("")
    p = d / "messy.cov"
    p.write_text("\n".join(rows) + "\n")
    return str(p), d


@pytest.mark.parametrize("impute", ["ignore", "mean"])
@pytest.mark.parametrize("missing", [[], [0, 5, 39]])
def test_read_cov_matches_reference(messy_cov, impute, missing, tmp_path):
    path, _ = messy_cov
    ref_dir, got_dir = tmp_path / "ref", tmp_path / "got"
    ref_dir.mkdir()
    got_dir.mkdir()
    ref, ref_miss = jax_readers.read_cov(
        path, missing_indvs=missing, cov_impute_method=impute,
        one_hot_conversion=True, categorical_threshold=5,
        one_hot_dir=str(ref_dir))
    got, got_miss = readers.read_cov(
        path, missing_indvs=missing, cov_impute_method=impute,
        one_hot_conversion=True, categorical_threshold=5,
        one_hot_dir=str(got_dir))
    np.testing.assert_array_equal(got, ref)
    assert got_miss == ref_miss
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir))
    for name in os.listdir(ref_dir):
        assert (got_dir / name).read_text() == (ref_dir / name).read_text()


def test_small_readers_match_reference(small_dataset, filtered_dataset):
    ds = small_dataset
    n_ref, fam_ref = jax_readers.read_fam(ds["prefix"] + ".fam")
    n_got, fam_got = readers.read_fam(ds["prefix"] + ".fam")
    assert n_got == n_ref
    np.testing.assert_array_equal(fam_got.astype(np.float64),
                                  fam_ref.to_numpy(np.float64))
    assert str(fam_got[7, 0]) == str(fam_ref.iloc[7, 0])
    assert readers.read_bim(ds["prefix"] + ".bim") == \
        jax_readers.read_bim(ds["prefix"] + ".bim")
    for path in (ds["annot1_path"], ds["annot8_path"]):
        for a, b in zip(readers.read_annot(path),
                        jax_readers.read_annot(path)):
            np.testing.assert_array_equal(a, b)
    for path in (ds["pheno_path"], filtered_dataset["pheno_path"]):
        y, miss, binary = readers.read_pheno(path)
        y0, miss0, binary0 = jax_readers.read_pheno(path)
        np.testing.assert_array_equal(y, y0)
        assert (miss, binary) == (miss0, binary0)
    got = readers.read_env_file(ds["env_path"])
    ref = jax_readers.read_env_file(ds["env_path"])
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("which,cov,env", [
    ("small", True, True), ("small", False, False), ("filtered", True, False),
])
def test_load_dataset_matches_reference(small_dataset, filtered_dataset,
                                        which, cov, env):
    ds = small_dataset if which == "small" else filtered_dataset
    kw = dict(annot_file=ds["annot8_path"], pheno_file=ds["pheno_path"],
              cov_file=ds["cov_path"] if cov else None,
              env_file=ds["env_path"] if env else None,
              num_random_vec=6, seed=9)
    got = load_dataset(ds["prefix"], **kw)
    ref = jax_load_dataset(ds["prefix"], **kw)
    for name in ("annot", "len_bin", "pheno", "cov", "Q", "env", "Z",
                 "Uzb"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.missing_indv == ref.missing_indv
    assert (got.num_indv, got.num_snp, got.num_bin, got.num_env) == \
        (ref.num_indv, ref.num_snp, ref.num_bin, ref.num_env)
    assert (got.bed.keep_idx is None) == (ref.bed.keep_idx is None)
    if ref.bed.keep_idx is not None:
        np.testing.assert_array_equal(got.bed.keep_idx, ref.bed.keep_idx)
    np.testing.assert_array_equal(got.bed.read_packed_block(0, 50),
                                  ref.bed.read_packed_block(0, 50))


@pytest.mark.parametrize("which,cov", [("small", False), ("filtered", True)])
def test_static_arrays_match_jax_engine(small_dataset, filtered_dataset,
                                        which, cov):
    ds = small_dataset if which == "small" else filtered_dataset
    data = jax_load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            cov_file=ds["cov_path"] if cov else None,
                            env_file=ds["env_path"], num_random_vec=4,
                            seed=7)
    eng = JaxEngine(data, JaxModelSpec.build("genie", "G+GxE+NxE",
                                             data.num_env),
                    JaxRunConfig(num_random_vec=4, num_jack=4, seed=7,
                                 dtype="float32", use_pallas=True))
    st = static_arrays_from_numpy(
        data.Z, data.Uzb, data.cov, data.Q, eng.Y_resid, data.bed.keep_idx,
        data.bed.num_indiv, torch.device("cpu"), env=data.env)
    assert st.n_pad == eng.n_pad
    np.testing.assert_array_equal(st.perm, eng.perm)
    # the residualized phenotypes are the probe matrix's last columns
    pairs = [(st.P, eng.P), (st.Z, eng.Zd), (st.Uzb, eng.Uzbd),
             (st.valid_mask, eng.valid_mask), (st.q_last, eng.q_last),
             (st.env, eng.envd), (st.Y, np.asarray(eng.P)[:, -1:])]
    if cov:
        pairs += [(st.C, eng.Cd), (st.Q, eng.Qd)]
    else:
        assert st.C is None and st.Q is None and eng.Cd is None
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_port_imports_neither_jax_nor_pandas():
    mods = [
        "pyrhe_tpu_torch", "pyrhe_tpu_torch.cli",
        "pyrhe_tpu_torch.utils.types", "pyrhe_tpu_torch.utils.logger",
        "pyrhe_tpu_torch.io.bed", "pyrhe_tpu_torch.io.synth",
        "pyrhe_tpu_torch.io.readers", "pyrhe_tpu_torch.core.data",
        "pyrhe_tpu_torch.core.solver", "pyrhe_tpu_torch.core.normal_eq",
        "pyrhe_tpu_torch.core.engine", "pyrhe_tpu_torch.ops.kernels",
        "pyrhe_tpu_torch.ops.moments", "pyrhe_tpu_torch.ops.decode",
        "pyrhe_tpu_torch.models.base",
        "pyrhe_tpu_torch.models.rhe", "pyrhe_tpu_torch.models.rhe_dom",
        "pyrhe_tpu_torch.models.genie",
        "pyrhe_tpu_torch.core.checkpoint",
        "pyrhe_tpu_torch.parallel.distributed",
        "pyrhe_tpu_torch.parallel.sharded",
        "pyrhe_tpu_torch.profile_run", "pyrhe_tpu_torch.cohort",
        "pyrhe_tpu_torch.constant", "pyrhe_tpu_torch.utils.generate_annot",
        "pyrhe_tpu_torch.utils.add_cov_pheno",
        "pyrhe_tpu_torch.simulate_pheno",
        "pyrhe_tpu_torch.sweep_phenotypes",
        "pyrhe_tpu_torch.bench.timing", "pyrhe_tpu_torch.bench.matvec",
        "pyrhe_tpu_torch.bench.kernels", "pyrhe_tpu_torch.bench.e2e",
        "pyrhe_tpu_torch.bench.host_read", "pyrhe_tpu_torch.bench.staging",
        "pyrhe_tpu_torch.bench.scaling_study",
    ]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'pandas',\n"
            "                                    'pyrhe_tpu'))\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "CLEAN" in res.stdout


def test_host_tools_import_without_torch():
    """The host-only tools (numpy) do not import torch: the package imports
    its model classes on first use. The classes are still there."""
    code = ("import sys\n"
            "import pyrhe_tpu_torch.simulate_pheno, pyrhe_tpu_torch.constant\n"
            "import pyrhe_tpu_torch.utils.generate_annot\n"
            "import pyrhe_tpu_torch.utils.add_cov_pheno\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "from pyrhe_tpu_torch import RHE, StreamingGENIE, Logger\n"
            "assert 'torch' in sys.modules and RHE.MODEL == 'rhe'\n"
            "import pyrhe_tpu_torch as p\n"
            "assert p.StreamingRHE.STREAMING and not hasattr(p, 'nope')\n"
            "print('CLEAN')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ROOT},
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "CLEAN" in res.stdout


@pytest.mark.parametrize("device", ["auto", "cuda", "gpu"])
def test_cuda_device_without_card_raises(monkeypatch, small_dataset,
                                         device):
    from pyrhe_tpu_torch import RHE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pick_device(device)
    ds = small_dataset
    with pytest.raises(RuntimeError, match="is_available"):
        RHE(geno_file=ds["prefix"], annot_file=ds["annot1_path"],
            pheno_file=ds["pheno_path"], num_jack=4, num_random_vec=4,
            device=device)
    assert pick_device("cpu") == torch.device("cpu")


def test_cpu_wrappers_never_touch_the_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU wrapper call reached the kernel build")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "_lib", None)
    words = torch.zeros((32, 128), dtype=torch.int32)
    before = dict(kernels.launches)
    for square in (False, True):
        kernels.gp_matmul(words, torch.ones((2048, 3)), square)
        kernels.ytg_matmul(words, torch.ones((4, 32), dtype=torch.bfloat16),
                           square)
    kernels.ytg_acc_matmul(
        words, torch.ones((4, 32)), torch.zeros((2, 1)),
        torch.ones((1, 2048)), torch.ones((1, 2048)),
        torch.zeros((2, 2048)), split=True)
    kernels.ytg_acc2_matmul(
        words, torch.ones((4, 32)), torch.ones((4, 32)), torch.zeros((2, 1)),
        torch.ones((1, 2048)), torch.zeros((2, 2048)), split=True)
    assert kernels.launches == before
    assert set(kernels.launches) == set(kernels.KERNELS)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.gp_matmul(words.to("meta"), torch.ones((2048, 3),
                                                       device="meta"))


def test_port_builds_its_own_bed_decoder(small_dataset):
    """The native .bed decoder compiles from the port's own source (no
    path under the JAX package) and decodes a block exactly as the numpy
    path does; no port module names a path under pyrhe_tpu/."""
    import re

    from pyrhe_tpu_torch.io import bed
    port = os.path.join(ROOT, "pyrhe_tpu_torch")
    assert os.path.commonpath([bed._SRC_PATH, port]) == port
    assert os.path.isfile(bed._SRC_PATH)
    lib = bed._load_native()
    assert lib is not None
    so = os.path.join(bed._NATIVE_DIR, "libbeddecode.so")
    assert os.path.getmtime(so) >= os.path.getmtime(bed._SRC_PATH)
    ds = small_dataset
    n, _ = readers.read_fam(ds["prefix"] + ".fam")
    m = readers.read_bim(ds["prefix"] + ".bim")
    bf = bed.BedFile(ds["prefix"] + ".bed", n, m)
    packed = bf.read_packed_block(0, m)
    np.testing.assert_array_equal(bf.read_block(0, m),
                                  bed.decode_packed(packed, n))
    path_literal = re.compile(r"""['"]pyrhe_tpu['"/]""")
    for dirpath, _, files in os.walk(port):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                text = open(os.path.join(dirpath, f)).read()
                assert not path_literal.search(text), f
