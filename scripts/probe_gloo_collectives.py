#!/usr/bin/env python3
"""Which collectives the gloo backend takes on CUDA tensors, two ranks on
one card, and their host-clock times.

    python3 scripts/probe_gloo_collectives.py

Two processes (``repro_torch.runtime.mesh.spawn``; gloo, since NCCL
refuses two ranks on one device) try all_to_all_single,
all_gather_into_tensor, reduce_scatter_tensor and all_reduce on 1 M
elements a rank of int8, f32 and bf16, on the card and on the host, and
print for each whether gloo took it, its result check and its seconds;
then the seconds of a 64 MB and a 256 MB f32 all_reduce (card and host)
and int8 all_to_all (host), and of a host-card round trip of the same
bytes. It is the evidence for ``runtime.mesh``'s rule that the native
collectives carry CUDA tensors through gloo; the port itself catches no
collective's failure.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch                                   # noqa: E402
import torch.distributed as dist               # noqa: E402


def _trial(out, name, fn):
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"ok": True, "s": time.perf_counter() - t0,
                     "check": res}
    except (RuntimeError, ValueError) as e:   # what gloo refuses
        out[name] = {"ok": False, "err": repr(e)[:300]}


def work(rank, world, dev):
    out = {}
    n = 1 << 20
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        for dt in (torch.int8, torch.float32, torch.bfloat16):
            x = torch.full((n * world,), rank + 1, dtype=dt, device=d)
            y = torch.empty_like(x)
            s = torch.full((n,), rank + 1, dtype=dt, device=d)
            g = torch.empty((n * world,), dtype=dt, device=d)
            r = torch.empty((n,), dtype=dt, device=d)
            z = s.clone()
            tag = f"{where} {str(dt).replace('torch.', '')}"
            _trial(out, f"all_to_all_single {tag}", lambda: (
                dist.all_to_all_single(y, x), float(y[:n].float().sum()))[1])
            _trial(out, f"all_gather_into_tensor {tag}", lambda: (
                dist.all_gather_into_tensor(g, s),
                [float(g[:n].float().mean()),
                 float(g[n:].float().mean())])[1])
            _trial(out, f"reduce_scatter_tensor {tag}", lambda: (
                dist.reduce_scatter_tensor(r, x.clone()),
                float(r.float().mean()))[1])
            _trial(out, f"all_reduce {tag}", lambda: (
                dist.all_reduce(z), float(z.float().mean()))[1])
    for mb in (64, 256):
        t = torch.ones(mb << 18, dtype=torch.float32, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out[f"all_reduce cuda f32 {mb} MB s"] = time.perf_counter() - t0
        h = t.cpu()
        t0 = time.perf_counter()
        dist.all_reduce(h)
        out[f"all_reduce cpu f32 {mb} MB s"] = time.perf_counter() - t0
        q = torch.ones(mb << 20, dtype=torch.int8)
        o = torch.empty_like(q)
        t0 = time.perf_counter()
        dist.all_to_all_single(o, q)
        out[f"all_to_all cpu int8 {mb} MB s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        q.to(dev).cpu()
        out[f"host-card round trip int8 {mb} MB s"] = (time.perf_counter()
                                                       - t0)
    return out


def main():
    if not torch.cuda.is_available():
        print("probe_gloo_collectives: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.runtime.mesh import spawn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    with tempfile.TemporaryDirectory() as d:
        res = spawn(work, 2, "cuda", os.path.join(d, "store"), timeout=300)
    for k, v in res[0].items():
        print(k, json.dumps(v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
