"""The port stands alone: `ofq_tpu_torch` and `chip_smoke.py` import neither
JAX/Flax nor anything of the JAX package `ofq_tpu`."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|ofq_tpu)\b(?!_torch)"
    r"|from\s+(jax|flax|ofq_tpu)\b(?!_torch))", re.M)


def _sources():
    files = sorted((REPO / "ofq_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_no_forbidden_import_statements():
    bad = []
    for path in _sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            bad.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not bad, bad


def test_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from flax import linen",
                 "import ofq_tpu", "from ofq_tpu.quant import lsq",
                 "    from ofq_tpu import serve"):
        assert FORBIDDEN.search(line), line
    for line in ("import ofq_tpu_torch", "from ofq_tpu_torch.ops import x",
                 "import jaxlib_free_module_name_is_not_jax"):
        assert not FORBIDDEN.search(line), line


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import ofq_tpu_torch, ofq_tpu_torch.serve, ofq_tpu_torch.calibrate\n"
        "import ofq_tpu_torch.convert, ofq_tpu_torch.models\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'ofq_tpu') or m.startswith(('jax.', 'flax.', 'ofq_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
