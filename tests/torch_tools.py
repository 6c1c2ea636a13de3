"""Shared set-up of the tests of the port's tools (tests/test_torch_roofline.py,
tests/test_torch_viz.py): the tiny flags, a synthetic corpus with the tiny
fp32 model's weights and the port's ``cli viz`` collages of them, and the
JAX package's ``cli viz`` on them in a fresh interpreter.

JAX's ``cli viz`` jits two programs: the model's init, whose values
``_load_params`` only uses for the parameter tree that the ``.pth`` then
fills whole, and the forward. In that interpreter ``jax.jit`` is wrapped:
the init (the one program called with a bare PRNG key) returns zeros of
its shapes from ``jax.eval_shape``, skipping a compile of ~6 s, and the
forward compiles with XLA's passes and no LLVM optimization, whose outputs
differ from the optimized program's by ~1e-6 (tests/test_torch_spatial.py).
Any parameter the ``.pth`` did not fill would be printed by
``partial_restore_params``; the caller checks that none was.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import cv2
import torch

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.models.camradepth import create_model

ROOT = Path(__file__).resolve().parents[1]
HW = (64, 128)
TINY = ["--set", "model.img_size=64,128", "--set", "model.dims=16,32,32,64",
        "--set", "model.ff_expansion=2,2,2,2", "--set",
        "model.depths=1,1,1,1", "--set", "model.mid_channels=32", "--set",
        "data.image_dimension=64,128", "--set",
        "model.compute_dtype=float32"]
NUM_VIS = 4
# collage pixels that may differ between two fp32 forwards agreeing to
# ~1e-5: the colormap quantizes depth to 256 levels, so a pixel within
# that of a level boundary may flip
PIXEL_SHARE = 1e-3

_JAX_VIZ = (
    "import sys\n"
    "import jax\n"
    "import numpy as np\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "from camradepth_tpu import cli\n"
    "real_jit = jax.jit\n"
    "def jit(fn, **kw):\n"
    "    compiled = {}\n"
    "    def call(*args):\n"
    "        if len(args) == 1 and np.shape(args[0]) == (2,):\n"
    "            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),\n"
    "                                jax.eval_shape(fn, *args))\n"
    "        key = str(jax.tree.map(lambda a: (np.shape(a), str(a.dtype)),\n"
    "                               args))\n"
    "        if key not in compiled:\n"
    "            compiled[key] = real_jit(fn, **kw).lower(*args).compile(\n"
    "                compiler_options={'xla_backend_optimization_level': 0})\n"
    "        return compiled[key](*args)\n"
    "    return call\n"
    "jax.jit = jit\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def viz_corpus(tmp: Path) -> dict:
    """A 6-frame synthetic corpus (one rain frame among the first 4), the
    tiny fp32 model's weights as a reference ``.pth`` and the ``cli viz``
    arguments over them (without ``--out``)."""
    split = str(synthetic.generate(tmp / "data", num_frames=6, hw=HW, seed=3))
    model = create_model(dataclasses.replace(tiny_test_config().model,
                                             compute_dtype="float32"),
                         device="cpu", seed=5)
    weights = tmp / "w.pth"
    torch.save({"state_dict": model.state_dict()}, weights)
    args = ["viz", "--split", split, "--set", "data.mini_dataset=1",
            "--checkpoint", str(weights), "--num-vis", str(NUM_VIS),
            "--test-batch", "4", *TINY]
    return {"tmp": tmp, "split": split, "weights": weights, "args": args,
            "model": model}


def port_viz(corpus: dict, out: Path, args=None) -> None:
    assert cli.main([*(args or corpus["args"]), "--out", str(out),
                     "--device", "cpu"]) == 0


def start_jax_viz(corpus: dict, out: Path) -> subprocess.Popen:
    """``camradepth_tpu.cli viz`` on the corpus into ``out``, in a fresh
    interpreter (see the module docstring)."""
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_VIZ, *corpus["args"], "--out", str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def pngs(d: Path) -> dict:
    return {p.name: cv2.imread(str(p)) for p in sorted(d.glob("*.png"))}


def differing(got: dict, want: dict):
    """(pixels that differ, pixels) over two sets of collages with the
    same names."""
    assert sorted(got) == sorted(want)
    diff = sum(int((got[k] != want[k]).any(-1).sum()) for k in got)
    return diff, sum(v.shape[0] * v.shape[1] for v in got.values())
