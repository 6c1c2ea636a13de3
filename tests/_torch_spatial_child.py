"""One rank of tests/test_torch_spatial.py's gloo group (CPU, fp32),
forked by tests/torch_ranks.py:

    python tests/torch_ranks.py tests._torch_spatial_child 4 <in_dir>
        <out_dir> <port> <port_a> <port_b>

``in_dir`` holds what the module writes while the ranks start, ``spec.json``
last (the variants' model configs and the cli serve flags): each
variant's weights (``<variant>.pth``) and input (``<variant>_x.npy``), and
the synthetic split. The rank joins a gloo group of 4 ranks at ``port``
and runs, each wrapper's calls counted per forward:

  1. sp = 2 alone: ranks 0-1 the first variant, ranks 2-3 the second, each
     pair its own sp group, the outputs and guidance-head logits gathered
     whole on every rank of the pair;
  2. data 2 x sp 2 on all four ranks (``parallel/mesh.ServingMesh``) for
     each variant, the outputs gathered to rank 0;
  3. an HTTP server on rank 0 over the data 2 x sp 2 engine of the first
     variant (``serving_http.MeshLeader``; the others ``follow``): 3
     concurrent single-frame POSTs, each answer against the engine's
     ``infer_batch`` of its frame;
  4. then, in new groups, ``cli serve --spatial-parallel 2`` on ranks 0-1
     (at ``port_a``) and ``cli serve --data-parallel 2`` on ranks 2-3 (at
     ``port_b``) over the split.

Rank 0 of each run writes ``<run>.npz`` into ``out_dir``; every rank writes
``rank<rank>.json`` (its counts and the HTTP checks).
"""

import io
import json
import os
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import ModelConfig, preset
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.parallel import multihost, spatial
from camradepth_tpu_torch.parallel.mesh import ServingLayout, ServingMesh
from camradepth_tpu_torch.serving import DepthEngine
from camradepth_tpu_torch.serving_http import MeshLeader, follow, start_server
from tests.spatial_port import count_calls, model_outputs


def load(spec, in_dir, variant):
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in spec["models"][variant].items()})
    state = torch.load(in_dir / f"{variant}.pth")["state_dict"]
    x = torch.from_numpy(np.load(in_dir / f"{variant}_x.npy"))
    return cfg, create_model(cfg, device="cpu", state_dict=state), x


def sharded_forward(model, x, shard, batch=slice(None)):
    """This rank's outputs under ``shard`` and the calls of each wrapper."""
    with count_calls() as calls, spatial.sharded(shard), torch.no_grad():
        got = model_outputs(model, x[batch, shard.rows(x.shape[1])])
    return got, dict(calls)


def main(rank, world, argv):
    # below the test workers' priority: the ranks take the cores they leave
    # idle, and the module's worker has time to wait for them
    os.nice(10)
    torch.set_num_threads(1)
    in_dir, out_dir = Path(argv[0]), Path(argv[1])
    port, port_a, port_b = (int(v) for v in argv[2:5])
    # the module writes spec.json last, while the ranks start
    for _ in range(6000):
        if (in_dir / "spec.json").exists():
            break
        time.sleep(0.05)
    spec = json.loads((in_dir / "spec.json").read_text())
    variants = list(spec["models"])
    out = {}

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]

    # 1. sp = 2 alone, one variant per pair
    variant = variants[rank // 2]
    cfg, model, x = load(spec, in_dir, variant)
    shard = spatial.RowShard(spatial.partition(cfg.img_size[0], 2), rank % 2,
                             pairs[rank // 2])
    got, out["sp2_calls"] = sharded_forward(model, x, shard)
    with spatial.sharded(shard):
        whole = {k: spatial.all_gather_rows(v) for k, v in got.items()}
    if rank % 2 == 0:
        np.savez(out_dir / f"sp2_{variant}.npz",
                 **{k: v.numpy() for k, v in whole.items()})

    # 2. data 2 x sp 2 over the four ranks, each variant
    mesh = ServingMesh(ServingLayout(2, 2), spec["img_height"])
    for variant in variants:
        cfg, model, x = load(spec, in_dir, variant)
        got, out[f"mesh_calls_{variant}"] = sharded_forward(
            model, x, mesh.rows, mesh.batch_rows(x.shape[0]))
        whole = {k: mesh.gather(v) for k, v in got.items()}
        if rank == 0:
            np.savez(out_dir / f"mesh_{variant}.npz",
                     **{k: v.numpy() for k, v in whole.items()})

    # 3. HTTP on rank 0 over the data 2 x sp 2 engine of the first variant
    cfg, model, x = load(spec, in_dir, variants[0])
    exp = preset("base").replace(model=cfg)
    engine = DepthEngine(exp, model, batch_size=2, device="cpu", mesh=mesh)
    engine.warmup()
    if rank == 0:
        out.update(http_checks(engine, exp, x))
    else:
        follow(engine)
    multihost.shutdown()

    # 4. cli serve over the split: sp 2 on ranks 0-1, data 2 on ranks 2-3
    layout, at = ((["--spatial-parallel", "2"], port_a) if rank < 2
                  else (["--data-parallel", "2"], port_b))
    run = "cli_sp2" if rank < 2 else "cli_dp2"
    out["cli_rc"] = cli.main(
        ["serve", "--coordinator", f"127.0.0.1:{at}", "--num-processes",
         "2", "--process-id", str(rank % 2), "--out", str(out_dir / run)]
        + layout + spec["serve_flags"])
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"[{rank}] DONE", flush=True)


def http_checks(engine, exp, x):
    """Rank 0's HTTP server over ``engine``: 3 concurrent single-frame
    POSTs, each answer against ``infer_batch`` of its frame; then it stops
    the ranks that follow."""
    leader = MeshLeader(engine)
    srv, _ = start_server(leader, exp, "127.0.0.1", 0, batch_window_ms=1000.0)
    frames = [np.ascontiguousarray(x[i % x.shape[0]].numpy() + i)
              for i in range(3)]
    answers = [None] * len(frames)
    barrier = threading.Barrier(len(frames))

    def post(i):
        buf = io.BytesIO()
        np.save(buf, frames[i])
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/depth",
            data=buf.getvalue(), method="POST")
        barrier.wait(timeout=60)
        with urllib.request.urlopen(req, timeout=120) as r:
            answers[i] = (r.status, np.load(io.BytesIO(r.read()))["depth"])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.shutdown()
    srv.server_close()
    srv._camradepth_aggregator.close()
    out = {"http_batches": engine.stats()["batches"], "http": [
        {"status": code, "shape": list(depth.shape),
         "equal": bool(np.array_equal(
             depth, leader.infer_batch(frames[i][None])["depth"]))}
        for i, (code, depth) in enumerate(answers)]}
    leader.stop()
    return out
