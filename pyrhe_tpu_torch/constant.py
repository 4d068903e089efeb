"""Directory constants sourced from a `.env` file: the port's copy of
pyrhe_tpu/constant.py (reference constant.py:1-6 uses python-dotenv; the
same KEY=VALUE format is parsed inline so no extra dependency is needed).

Looked up in the current working directory, then the repository root.
Missing keys default to the current directory.
"""
from __future__ import annotations

import os


def _load_dotenv() -> dict:
    for base in (os.getcwd(), os.path.dirname(os.path.dirname(__file__))):
        path = os.path.join(base, ".env")
        if os.path.exists(path):
            out = {}
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#") or "=" not in line:
                        continue
                    k, v = line.split("=", 1)
                    out[k.strip()] = v.strip().strip("'\"")
            return out
    return {}


_env = _load_dotenv()

# Real environment variables win over .env values (python-dotenv's default
# no-override precedence, which the reference's constant.py relies on).
RESULT_DIR = os.environ.get("RESULT_DIR", _env.get("RESULT_DIR", "."))
DATA_DIR = os.environ.get("DATA_DIR", _env.get("DATA_DIR", "."))
HOME_DIR = os.environ.get("HOME_DIR", _env.get("HOME_DIR", "."))
