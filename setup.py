"""Package pyrhe_tpu (pip-installable; mirrors reference pyrhe/setup.py)."""
from setuptools import find_packages, setup

setup(
    name="pyrhe_tpu",
    version="0.1.0",
    description=("TPU-native randomized Haseman-Elston regression: "
                 "RHE, RHE-DOM and GENIE heritability estimation on "
                 "JAX/XLA/Pallas"),
    packages=find_packages(include=["pyrhe_tpu", "pyrhe_tpu.*",
                                    "pyrhe_tpu_torch", "pyrhe_tpu_torch.*"]),
    package_data={"pyrhe_tpu.io": ["_native/*.cpp"],
                  "pyrhe_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy>=1.23.1",
        "pandas>=1.5.1",
        "scipy>=1.10.1",
    ],
    entry_points={
        "console_scripts": [
            "pyrhe-tpu = pyrhe_tpu.cli:cli_entry",
            "pyrhe-tpu-torch = pyrhe_tpu_torch.cli:cli_entry",
        ],
    },
)
