"""The port's tools against the JAX package's, on the CPU: the roofline,
``cli summary``, scaling and profiling (camradepth_tpu_torch.utils.
{roofline,scaling,profiling}), ``cli viz`` and ``cli doctor``. The module
holds the tests whose JAX references cost seconds of tracing or compile:
they run in fresh interpreters started with the module (JAX's ``base``
summary, ~8 s of tracing; JAX's ``cli viz``, ``tests/torch_tools.py``;
the port's ``cli doctor``), while the other tests run.

- ``cli summary`` at the tiny widths (fp32) and at ``base`` (416x800,
  batch 8): the TOTAL parameter count equals ``camradepth_tpu.cli
  summary``'s, and the matmul GFLOPs per frame agree within 0.1 % (JAX's
  count also holds the two 8-tap depthwise convolutions by which XLA forms
  each bicubic x2, which the port runs in its kernel).
- The roofline's matmul-class ops at the tiny widths: (kind, M, K, N) and
  FLOPs of every conv and dense product, depthwise convs bandwidth-only,
  equal JAX's ``rl.analyze(...).matmuls`` (``make_jaxpr`` only, no
  compile). Named apart: JAX's attention einsum, one ``dot`` of M = B*h*N,
  K = d, N = keys per block, which the port runs in its scores kernel
  (same M, K, N and FLOPs), and JAX's two bicubic depthwise convs per
  decoder stage, which the port's bicubic kernel runs.
- At ``base``, bf16, batch 8 the kernels' floors reproduce PERF.md
  section 6's bound column: scores 0.080 ms, bicubic 0.342, GELU 2.198.
- ``cli viz`` at the tiny widths in fp32 on one ``.pth``, over 4 frames:
  the same file names as ``camradepth_tpu.cli viz``'s and at most 0.1 %
  of collage pixels differing (the count is printed).
- ``project_dp_scaling`` equals JAX's bit for bit given the same
  ``axis_bw``; ``StepTimer.summary`` equals JAX's on the same recorded
  times; ``trace`` writes a Chrome trace and ``flops_estimate`` counts a
  matmul.
- ``cli doctor`` without a card: exit code 1 and a no-card line, within
  its timeout.
"""

import collections
import json
import subprocess
import sys
import time

import pytest
import torch

from camradepth_tpu import cli as jcli
from camradepth_tpu.utils import profiling as jprof
from camradepth_tpu.utils import roofline as jrl
from camradepth_tpu.utils import scaling as jscaling
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.utils import profiling, roofline as rl, scaling
from tests import torch_tools as T
from tests.torch_port import one_torch_thread  # noqa: F401

ROOT = T.ROOT
TINY = T.TINY
# PERF.md section 6, bound column: per bf16 batch-8 forward of base at
# 416x800, bytes over 3.35 TB/s or operations over 989 (bf16) / 67 (fp32)
# TFLOP/s, as chip_smoke.py phase (b) computes them
TABLE_BOUND_MS = {"maxpool_attention_scores": 0.080,
                  "upsample_bicubic_x2": 0.342, "gelu_bf16": 2.198}
GFLOPS_RTOL = 1e-3
DOCTOR_TIMEOUT_S = 60

_JAX_BASE = (
    "import json, jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "from camradepth_tpu import cli\n"
    "cli.main(['summary', '--preset', 'base'])\n"
)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """What runs beside the module's tests, started with it, each in an
    interpreter of its own: JAX's ``base`` summary, JAX's ``cli viz`` (on
    the corpus of ``torch_tools.viz_corpus``) and the port's ``cli
    doctor``."""
    corpus = T.viz_corpus(tmp_path_factory.mktemp("tools"))

    def start(argv):
        return subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {
        "base": start([sys.executable, "-c", _JAX_BASE]),
        "viz": T.start_jax_viz(corpus, corpus["tmp"] / "jax"),
        "doctor": start([sys.executable, "-m", "camradepth_tpu_torch.cli",
                         "doctor", "--timeout", str(DOCTOR_TIMEOUT_S)])}
    yield {"corpus": corpus, "procs": procs, "t0": time.perf_counter()}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _summary(text: str):
    """(TOTAL params, matmul GFLOPs per frame) of a summary's output."""
    total = next(int(line.split()[1].replace(",", ""))
                 for line in text.splitlines() if line.startswith("TOTAL"))
    gf = next(float(line.split()[2]) for line in text.splitlines()
              if line.startswith("matmul GFLOPs/frame:"))
    return total, gf


def _run_summary(main, owner, name, argv, monkeypatch, capsys):
    """(stdout, the Roofline that ``owner.name`` returned) of one
    summary."""
    got = []
    real = getattr(owner, name)

    def capture(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]

    monkeypatch.setattr(owner, name, capture)
    capsys.readouterr()
    assert main(["summary", *argv]) == 0
    monkeypatch.undo()
    return capsys.readouterr().out, got[0]


def _key(op):
    return (op.kind, op.m, op.k, op.n)


def test_tiny_op_list_and_summary_match_jax(started, monkeypatch,
                                            capsys):
    argv = [*TINY, "--summary-batch", "2"]
    j_out, j_r = _run_summary(jcli.main, jrl, "analyze", argv, monkeypatch,
                              capsys)
    p_out, p_r = _run_summary(cli.main, rl, "forward_roofline", argv,
                              monkeypatch, capsys)
    (j_total, j_gf), (p_total, p_gf) = _summary(j_out), _summary(p_out)
    print(f"tiny: TOTAL {p_total} (JAX {j_total}); GFLOPs/frame {p_gf} "
          f"(JAX {j_gf})")
    assert p_total == j_total
    assert abs(p_gf - j_gf) <= GFLOPS_RTOL * j_gf

    jax_ops = collections.Counter(_key(op) for op in j_r.matmuls)
    port_ops = collections.Counter(_key(op) for op in p_r.matmuls)
    # JAX's bicubic x2: per upsample two 8-tap depthwise convolutions
    # (camradepth_tpu/ops/resize.py:56-106), where the port launches its
    # bicubic kernel once
    bicubic = collections.Counter(
        {k: n for k, n in jax_ops.items() if k[0] == "dwconv" and k[2] == 8})
    n_up = sum(1 for op in p_r.kernels if op.name == "upsample_bicubic_x2")
    assert n_up == 5 and sum(bicubic.values()) == 2 * n_up
    assert jax_ops - bicubic == port_ops, (jax_ops - bicubic - port_ops,
                                           port_ops - (jax_ops - bicubic))
    # the attention scores: JAX's einsum "bnhd,bmhd->bhnm" is a dot of
    # M = B*h*N, K = d, N = keys; the port's scores kernel has its M, K, N
    # and FLOPs, one per encoder block
    scores = [op for op in p_r.matmuls if op.kernel]
    assert len(scores) == 4 and {op.kernel for op in scores} == {
        "maxpool_attention_scores"}
    j_dots = {_key(op): op.flops for op in j_r.matmuls if op.kind == "dot"}
    for op in scores:
        assert j_dots[_key(op)] == op.flops, _key(op)
    for op in p_r.matmuls:
        assert op.bw_only == (op.kind == "dwconv")
    # the port's floor model: wgmma padding in bf16, none in fp32
    op = rl.MatmulOp("conv", 100, 20, 30, 0, 16)
    assert op.padded_flops == 2.0 * 128 * 32 * 32
    assert rl.MatmulOp("conv", 100, 20, 30, 0, 32).padded_flops == op.flops


def test_scaling_matches_jax_bit_for_bit():
    for mode in ("weak", "strong"):
        kw = dict(n_chips=(1, 2, 3, 8, 64), mode=mode,
                  axis_bw=scaling.H100_NVLINK_BW)
        got = scaling.project_dp_scaling(21_966_595, 1.78276, **kw)
        want = jscaling.project_dp_scaling(21_966_595, 1.78276, **kw)
        assert [(p.n_chips, p.t_compute_s, p.t_comm_s, p.t_overlap_s,
                 p.t_serial_s, p.efficiency) for p in got] == [
            (p.n_chips, p.t_compute_s, p.t_comm_s, p.t_overlap_s,
             p.t_serial_s, p.efficiency) for p in want]
        text = scaling.format_projection(got, mode, 21_966_595, 6)
        assert "NVLink 450 GB/s" in text and "ICI" not in text
    with pytest.raises(ValueError, match="weak|strong"):
        scaling.project_dp_scaling(1, 1.0, mode="linear")


def test_step_timer_and_profiling(tmp_path):
    times = [0.25, 0.125, 0.5, 0.375, 1.0]
    got, want = profiling.StepTimer(warmup=1), jprof.StepTimer(warmup=1)
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()
    assert profiling.StepTimer().summary() == jprof.StepTimer().summary()
    t = profiling.StepTimer(warmup=1)
    for _ in range(3):
        t.start()
        t.stop(torch.ones(()))
    assert t.summary()["steps"] == 2
    with profiling.trace(str(tmp_path), enabled=False):
        pass
    assert not list(tmp_path.iterdir())
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8).sum()
    (trace,) = tmp_path.glob("trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert profiling.flops_estimate(
        lambda a, b: a @ b, torch.ones(64, 64), torch.ones(64, 64)
    ) == 2 * 64 ** 3


def test_base_summary_and_kernel_floors(started, monkeypatch, capsys):
    out, r = _run_summary(cli.main, rl, "forward_roofline",
                          ["--preset", "base"], monkeypatch, capsys)
    p_total, p_gf = _summary(out)
    assert not torch.cuda.is_initialized()
    # the kernels' floors of the roofline that cli bench records too
    floors = {k: round(v * 1e3, 3) for k, v in r.kernel_floors().items()}
    print(f"base bf16 batch 8 kernel floors (ms): {floors}")
    assert floors == TABLE_BOUND_MS
    assert [len([o for o in r.kernels if o.name == n])
            for n in ("upsample_bicubic_x2", "gelu_bf16")] == [5, 53]
    assert sum(1 for o in r.matmuls if o.kernel) == 34
    assert "unfused eager bytes" in r.report()
    proc = started["procs"]["base"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    j_total, j_gf = _summary(out)
    print(f"base: TOTAL {p_total} (JAX {j_total}); GFLOPs/frame {p_gf} "
          f"(JAX {j_gf})")
    assert p_total == j_total
    assert abs(p_gf - j_gf) <= GFLOPS_RTOL * j_gf


def test_cli_viz_matches_jax(started):
    corpus = started["corpus"]
    T.port_viz(corpus, corpus["tmp"] / "port")
    proc = started["procs"]["viz"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    assert f"wrote {T.NUM_VIS} collages" in out and "keeping init" not in out
    got, want = T.pngs(corpus["tmp"] / "port"), T.pngs(corpus["tmp"] / "jax")
    assert len(got) == T.NUM_VIS
    diff, total = T.differing(got, want)
    print(f"cli viz: {diff} of {total} collage pixels differ from "
          f"camradepth_tpu.cli viz ({100 * diff / total:.4f} %)")
    assert diff <= T.PIXEL_SHARE * total


def test_doctor_without_a_card(started):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = started["procs"]["doctor"]
    out, err = proc.communicate(timeout=2 * DOCTOR_TIMEOUT_S)
    seconds = time.perf_counter() - started["t0"]
    assert proc.returncode == 1, (out, err[-2000:])
    assert "card: NONE answered" in out, out
    assert "nvcc:" in out and "kernel build dir:" in out
    assert "native host library:" in out
    assert seconds < DOCTOR_TIMEOUT_S
