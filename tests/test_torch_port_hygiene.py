"""The port stands alone: `ofq_tpu_torch` and `chip_smoke.py` import neither
JAX/Flax nor anything of the JAX package `ofq_tpu` or of its lab benches
(`benchmarks`, which import JAX)."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|ofq_tpu|benchmarks)\b(?!_torch)"
    r"|from\s+(jax|flax|ofq_tpu|benchmarks)\b(?!_torch))", re.M)


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
                 "    from ofq_tpu import serve",
                 "from benchmarks import window_attn_lab",
                 "import benchmarks.window_attn_lab as lab"):
        assert FORBIDDEN.search(line), line
    for line in ("import ofq_tpu_torch", "from ofq_tpu_torch.ops import x",
                 "import jaxlib_free_module_name_is_not_jax"):
        assert not FORBIDDEN.search(line), line


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import ofq_tpu_torch, ofq_tpu_torch.serve, ofq_tpu_torch.calibrate\n"
        "import ofq_tpu_torch.convert, ofq_tpu_torch.models\n"
        "import ofq_tpu_torch.train, ofq_tpu_torch.train.loop\n"
        "import ofq_tpu_torch.train.cga\n"
        "import ofq_tpu_torch.deploy, ofq_tpu_torch.ops.int8_qlinear\n"
        "import ofq_tpu_torch.models.swin, ofq_tpu_torch.ops.window_attention\n"
        "import ofq_tpu_torch.benchmarks.window_attn_lab\n"
        "import ofq_tpu_torch.cli.train, ofq_tpu_torch.cli.cga\n"
        "import ofq_tpu_torch.cli.eval, ofq_tpu_torch.cli.runner\n"
        "import ofq_tpu_torch.cli.common, ofq_tpu_torch.data.pipeline\n"
        "import ofq_tpu_torch.utils.flops, ofq_tpu_torch.utils.profiling\n"
        "import ofq_tpu_torch.convert.flax\n"
        "import ofq_tpu_torch.convert.torch_import\n"
        "import ofq_tpu_torch.convert.torch_export\n"
        "import ofq_tpu_torch.train.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'ofq_tpu', 'benchmarks', 'window_attn_lab') or m.startswith(("
        "'jax.', 'flax.', 'ofq_tpu.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
