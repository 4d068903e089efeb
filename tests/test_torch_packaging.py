"""The port as setup.py installs it: every source the port builds at run
time (the CUDA kernels and the host .bed decoder under csrc/) ships in the
package data, every subpackage is packaged, and the console script runs
the port's CLI."""
import fnmatch
import os
import runpy

import pytest
import setuptools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pyrhe_tpu_torch")


@pytest.fixture(scope="module")
def setup_kwargs():
    """The keyword arguments setup.py hands to setuptools.setup, read by
    running it with setup() stubbed out, from the repository root."""
    got = {}
    real, cwd = setuptools.setup, os.getcwd()
    setuptools.setup = got.update
    os.chdir(ROOT)
    try:
        runpy.run_path(os.path.join(ROOT, "setup.py"))
    finally:
        setuptools.setup = real
        os.chdir(cwd)
    return got


def test_every_csrc_file_ships(setup_kwargs):
    globs = setup_kwargs["package_data"]["pyrhe_tpu_torch"]
    sources = sorted(os.listdir(os.path.join(PKG, "csrc")))
    assert "bed_decode.cpp" in sources and "rhe_kernels.cu" in sources
    for name in sources:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name


def test_every_subpackage_ships(setup_kwargs):
    want = {os.path.relpath(d, ROOT).replace(os.sep, ".")
            for d, _, files in os.walk(PKG) if "__init__.py" in files}
    assert "pyrhe_tpu_torch.bench" in want
    assert want <= set(setup_kwargs["packages"])


def test_console_script_runs_the_port_cli(setup_kwargs):
    scripts = dict(
        (part.strip() for part in entry.split("="))
        for entry in setup_kwargs["entry_points"]["console_scripts"])
    assert scripts["pyrhe-tpu-torch"] == "pyrhe_tpu_torch.cli:cli_entry"
    assert scripts["pyrhe-tpu"] == "pyrhe_tpu.cli:cli_entry"
    module, func = scripts["pyrhe-tpu-torch"].split(":")
    from pyrhe_tpu_torch import cli
    assert module == cli.__name__ and callable(getattr(cli, func))
