#!/usr/bin/env python3
"""Time the port's serving-artifact export, save and load at a preset's
depths, and the same without the graph pass that drops the trace's
assertions and identity casts (``interop/export.py``
``_drop_checks_and_identity_casts``).

    python3 tools/port_export_timing.py [--preset base] [--hw 64,128]
        [--dtype bfloat16] [--dynamic-batch] [--device cpu]

``torch.export`` traces with fake tensors, so its cost follows the number
of graph nodes (the model's depths), not the image size: a small image
measures the full-size export's host time without its memory. Prints one
line per variant: graph nodes, export, save and load seconds, and the
blob's MiB. Host times on a shared machine spread; compare the variants
within one run.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch
    from torch.export.passes import move_to_device_pass

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.interop import export as X
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import ServingForward

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="base")
    p.add_argument("--hw", default="64,128")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--dynamic-batch", action="store_true")
    p.add_argument("--device", default="cpu")
    args = p.parse_args()
    cfg = preset(args.preset)
    hw = tuple(int(v) for v in args.hw.split(","))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=hw, compute_dtype=args.dtype))
    model = create_model(cfg.model, device=args.device)

    def unpruned():
        # export_program without the graph pass
        module = ServingForward(cfg, X._weights_in(model, args.dtype))
        x = torch.zeros((8, *hw, cfg.model.input_channels),
                        device=args.device)
        dynamic = ({"x": {0: torch.export.Dim("batch", min=1)}}
                   if args.dynamic_batch else None)
        with torch.no_grad():
            ep = torch.export.export(module, (x,), dynamic_shapes=dynamic)
        ep = move_to_device_pass(ep, "cpu")
        ep._example_inputs = None
        return ep

    def exported():
        return X.export_program(cfg, model, 8, artifact_dtype=args.dtype,
                                dynamic_batch=args.dynamic_batch)

    for name, fn in (("unpruned", unpruned), ("export_program", exported),
                     ("unpruned", unpruned), ("export_program", exported)):
        t0 = time.perf_counter()
        ep = fn()
        t1 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        t2 = time.perf_counter()
        torch.export.load(io.BytesIO(buf.getvalue()))
        t3 = time.perf_counter()
        print(f"{name}: {len(ep.graph.nodes)} nodes, export {t1 - t0:.1f} s,"
              f" save {t2 - t1:.1f} s, load {t3 - t2:.1f} s, "
              f"{len(buf.getvalue()) / 2**20:.1f} MiB ({args.preset} "
              f"{args.dtype} at {hw[0]}x{hw[1]}, "
              f"{'dynamic' if args.dynamic_batch else 'batch 8'}, traced on "
              f"{args.device})", flush=True)


if __name__ == "__main__":
    import warnings

    warnings.filterwarnings("ignore", "No complete tensor found")
    warnings.filterwarnings("ignore", "The given buffer is not writable")
    main()
