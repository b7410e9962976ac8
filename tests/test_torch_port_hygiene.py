"""The port stands alone: `ofq_tpu_torch`, `chip_smoke.py` and the workers
the parallel tests start (`tests/torch_fixtures/*_worker.py`) import
neither JAX/Flax nor anything of the JAX package `ofq_tpu` or of its lab
benches (`benchmarks`, which import JAX), nor the image libraries that the
card's machine lacks (TensorFlow, PIL, OpenCV, torchvision)."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_NAMES = r"(jax|flax|ofq_tpu|benchmarks|tensorflow|PIL|cv2|torchvision)"
FORBIDDEN = re.compile(
    rf"^\s*(import\s+{_NAMES}\b(?!_torch)"
    rf"|from\s+{_NAMES}\b(?!_torch))", re.M)


def _sources():
    files = sorted((REPO / "ofq_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tests" / "torch_fixtures").glob("*_worker.py"))
    return files


def test_no_forbidden_import_statements():
    bad = []
    for path in _sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            bad.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not bad, bad


def test_sources_cover_the_parallel_layer():
    """`parallel/` (the port of `ofq_tpu/parallel/`, both axes) is among
    the scanned sources, every module of it, and the workers of the data-
    and tensor-parallel tests."""
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    for mod in ("__init__", "mesh", "multihost", "collectives", "tensor"):
        assert f"ofq_tpu_torch/parallel/{mod}.py" in names, mod
    for worker in ("parallel_worker", "tp_worker"):
        assert f"tests/torch_fixtures/{worker}.py" in names, worker


def test_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from flax import linen",
                 "import ofq_tpu", "from ofq_tpu.quant import lsq",
                 "    from ofq_tpu import serve",
                 "from benchmarks import window_attn_lab",
                 "import benchmarks.window_attn_lab as lab",
                 "import tensorflow as tf", "from PIL import Image",
                 "import cv2", "from torchvision import transforms"):
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
        "import ofq_tpu_torch.data.decode, ofq_tpu_torch.data.resize\n"
        "import ofq_tpu_torch.data.augment\n"
        "import ofq_tpu_torch.utils.flops, ofq_tpu_torch.utils.profiling\n"
        "import ofq_tpu_torch.convert.flax\n"
        "import ofq_tpu_torch.convert.torch_import\n"
        "import ofq_tpu_torch.convert.torch_export\n"
        "import ofq_tpu_torch.train.checkpoint\n"
        "import ofq_tpu_torch.parallel, ofq_tpu_torch.parallel.mesh\n"
        "import ofq_tpu_torch.parallel.multihost\n"
        "import ofq_tpu_torch.parallel.collectives\n"
        "import ofq_tpu_torch.parallel.tensor\n"
        "sys.path.insert(0, 'tests/torch_fixtures')\n"
        "import parallel_worker, tp_worker\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'ofq_tpu', 'benchmarks', 'window_attn_lab', 'tensorflow', 'PIL', "
        "'cv2', 'torchvision') or m.startswith(("
        "'jax.', 'flax.', 'ofq_tpu.', 'benchmarks.', 'tensorflow.', "
        "'PIL.', 'cv2.', 'torchvision.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
