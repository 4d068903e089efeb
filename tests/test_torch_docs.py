"""The port's API reference (docs/torch/api/, written by python -m
pyrhe_tpu_torch.api_docs): current, covering the public surfaces, indexed;
the counterpart of tests/test_docs.py for the JAX package's pages."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = os.path.join(ROOT, "docs", "torch", "api")

REQUIRED = {
    "pyrhe_tpu_torch_core_engine.md": ["class `Engine`", "class `RunConfig`",
                                       "class `ModelSpec`"],
    "pyrhe_tpu_torch_core_checkpoint.md": ["class `Checkpoint`"],
    "pyrhe_tpu_torch_core_solver.md": ["`jackknife_se", "`h2_overlapping"],
    "pyrhe_tpu_torch_models_rhe.md": ["class `RHE`", "class `StreamingRHE`"],
    "pyrhe_tpu_torch_models_rhe_dom.md": ["class `RHE_DOM`"],
    "pyrhe_tpu_torch_models_genie.md": ["class `GENIE`",
                                        "class `StreamingGENIE`"],
    "pyrhe_tpu_torch_ops_kernels.md": [
        f"`{name}(" for name in (
            "gp_matmul", "ytg_matmul", "ytg_acc_matmul", "ytg_acc2_matmul",
            "gp_plain", "ytg_plain", "ytg_acc_plain", "ytg_acc2_plain")],
    "pyrhe_tpu_torch_parallel_sharded.md": ["class `ShardedRunner`"],
    "pyrhe_tpu_torch_io_bed.md": ["class `BedFile`"],
    "pyrhe_tpu_torch_make_example.md": ["`main("],
}


def test_api_docs_build_clean_and_current():
    """The committed pages regenerate identically (stale docs fail), in a
    process that can import neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'pyrhe_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from pyrhe_tpu_torch import api_docs\n"
        "sys.exit(api_docs.main(['--check']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stdout + res.stderr


def test_api_docs_check_fails_on_a_stale_page(tmp_path):
    from pyrhe_tpu_torch import api_docs
    api_docs.build(str(tmp_path))
    assert api_docs.stale_pages(str(tmp_path)) == []
    page = tmp_path / "pyrhe_tpu_torch_make_example.md"
    page.write_text(page.read_text() + "edited\n")
    (tmp_path / "index.md").unlink()
    assert api_docs.stale_pages(str(tmp_path)) == [
        "index.md", "pyrhe_tpu_torch_make_example.md"]


def test_api_docs_cover_required_surfaces():
    for fname, needles in REQUIRED.items():
        with open(os.path.join(API, fname)) as f:
            text = f.read()
        for needle in needles:
            assert needle in text, (fname, needle)


def test_api_docs_index_lists_every_page():
    with open(os.path.join(API, "index.md")) as f:
        index = f.read()
    pages = sorted(p for p in os.listdir(API) if p != "index.md")
    assert len(pages) >= len(REQUIRED)
    for page in pages:
        assert f"]({page})" in index, page
