"""Helpers of the spatial parallel tests (tests/test_torch_spatial.py and its
gloo ranks, tests/_torch_spatial_child.py).

- :func:`count_calls` counts the calls of the three kernel wrappers a
  forward reaches (on the CPU a wrapper runs its plain version and counts
  no launch, so the calls are what a rank would launch on the card);
- :func:`model_outputs` is a forward's maps and the logits of its guidance
  heads, by name;
- :class:`ThreadShard` and :func:`on_threads` run an sp group's ranks as
  threads of one process, their collectives through a barrier, for the
  tests that start no process (forwards, and backwards with ``grad``).
"""

import collections
import contextlib
import dataclasses
import threading

import torch

from camradepth_tpu_torch.models import encoder, layers
from camradepth_tpu_torch.parallel import spatial

# the seg heads whose argmax maps feed the depth heads
GUIDANCE_HEADS = ("seg_conv_stage_4", "unsup_stage_4", "seg_conv_final",
                  "unsup_final")


@contextlib.contextmanager
def count_calls():
    """{wrapper: calls} of the enclosed forward, counted where the model
    calls them (the attention scores through ``maxpool_attention``, the
    bf16 GELU through ``gelu_for_dtype`` on a bf16 tensor)."""
    calls = collections.Counter({"attention": 0, "bicubic": 0, "gelu": 0})
    saved = {(mod, name): getattr(mod, name) for mod, name in (
        (encoder, "maxpool_attention"), (layers, "upsample_bicubic_x2"),
        (layers, "gelu_for_dtype"), (encoder, "gelu_for_dtype"))}

    def attention(*args):
        calls["attention"] += 1
        return saved[encoder, "maxpool_attention"](*args)

    def bicubic(x):
        calls["bicubic"] += 1
        return saved[layers, "upsample_bicubic_x2"](x)

    def gelu(x):
        calls["gelu"] += x.dtype == torch.bfloat16
        return saved[layers, "gelu_for_dtype"](x)

    for (mod, name), fn in zip(saved, (attention, bicubic, gelu, gelu)):
        setattr(mod, name, fn)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def model_outputs(model, x: torch.Tensor) -> dict:
    """The forward's maps (``final``, ``inter3``, ``inter4`` and the seg
    outputs a variant has) and its guidance heads' logits
    (``head:<name>``), all [B, H, W, ...] fp32 tensors."""
    heads = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda mod, args, y, name=name: heads.__setitem__(f"head:{name}", y))
        for name in GUIDANCE_HEADS if hasattr(model, name)]
    try:
        out = model(x)
    finally:
        for h in hooks:
            h.remove()
    d = out["depth"]
    got = {"final": d["final_depth"], "inter3": d["intermediate_depths"][2],
           "inter4": d["intermediate_depths"][3]}
    for key, v in out["seg"].items():
        if v is not None:
            got[key] = v
    got.update(heads)
    return {k: v.float() for k, v in got.items()}


class _Hub:
    """The meeting point of an sp group's threads."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots = [None] * n

    def exchange(self, index: int, t: torch.Tensor) -> list:
        self.slots[index] = t
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


@dataclasses.dataclass(frozen=True)
class ThreadShard(spatial.RowShard):
    """A rank of an sp group whose ranks are threads of this process."""

    hub: _Hub = None

    def all_gather(self, t):
        return [p.clone() for p in self.hub.exchange(self.index, t)]


def on_threads(fn, height: int, sp: int, grad: bool = False) -> list:
    """``fn(shard)`` on each rank of an sp group over an image ``height``
    rows tall, each rank a thread under its shard (with autograd on when
    ``grad``); the ranks' results."""
    counts = spatial.partition(height, sp)
    hub = _Hub(sp)
    results, errors = [None] * sp, []

    def run(i):
        # OpenMP's thread count is per thread: a new thread starts from the
        # default (a thread per core) whatever the module set
        torch.set_num_threads(1)
        shard = ThreadShard(counts, i, None, hub)
        try:
            with spatial.sharded(shard), torch.set_grad_enabled(grad):
                results[i] = fn(shard)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
