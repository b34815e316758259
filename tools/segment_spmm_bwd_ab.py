"""Time segment_spmm's backward kernels of one source tree on the card.

    python3 tools/segment_spmm_bwd_ab.py [--src DIR] [--tag TAG]

Imports the port from ``--src`` (default: this checkout's ``src``; give
an unpacked older commit's ``src`` to time it in the same call, parent,
change, change, parent) and prints one JSON line:

- "sum_bwd" (``ops.segment_spmm_bwd``) at GraphCast's Cora-sized
  training shape (E = 10,556, N = 2,708, D = 512, bf16) and at the
  products-sized graph's D = 64 in float32, beside ``dout.index_select(0,
  dst)``: the whole call's time with CUDA events around 10 calls
  (``call_ms``), each call's host time (``host_ms``: 200 calls enqueued
  without a synchronise, over 200) and its device time (``device_ms``:
  50 calls queued behind a sleep kernel);
- "gat_bwd": the backward of one ``gat_aggregate_ad`` call
  (``torch.autograd.grad`` of its output, which the tree's own backward
  computes) at GAT's layer 1 (H = 8, dout = 8) and layer 2 (dout = 7) on
  the products-sized graph, bf16 model with float32 sums, and layer 1 in
  float32: ``call_ms`` and its kernels' device ms by name
  (``torch.profiler``, in this fresh process); the forward's
  ``call_ms`` beside it, as training calls it (``fwd_call_ms``) and as
  serving does, without gradients (``fwd_serve_ms``); the peak memory of
  one backward above what it starts with;
- the compiler's register and spill lines of the tree's two libraries.

The graphs (``products_graph``, ``cora_graph``) and the timers are
``chip_smoke.py``'s; the graphs are built on the host from their seeds.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_ms(fn, iters: int = 5) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        out[e.key[:72]] = us / 1e3 / iters
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("segment_spmm_bwd_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import (_device_ms, _gnn_dims, _host_ms, cora_graph,
                            cuda_ms, products_graph)
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_spmm import kernel, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    f32, b16 = torch.float32, torch.bfloat16
    res = dict(tag=args.tag, src=args.src,
               card=torch.cuda.get_device_name(0))

    cora, products = cora_graph(), products_graph()
    n_p = _gnn_dims("ogb_products")["n_nodes"]
    dst_p = torch.as_tensor(products["edge_dst"], device=dev)
    for name, dst, n, D, dt, msgs_dt in (
            ("cora_d512_bf16", torch.as_tensor(cora["edge_dst"], device=dev),
             cora["node_feats"].shape[0], 512, b16, b16),
            ("products_d64_f32", dst_p, n_p, 64, f32, f32)):
        plan = ops.segment_plan(dst, n)
        dout = torch.randn((n, D), generator=gen, device=dev).to(dt)
        want = ops.segment_spmm_bwd_plain(dout, dst, msgs_dt)

        def call():
            return ops.segment_spmm_bwd(dout, dst, n, plan, msgs_dt)

        def lib():
            return dout.index_select(0, dst)

        torch.cuda.synchronize()
        res[f"sum_bwd_{name}"] = dict(
            bit_exact=bool(torch.equal(call(), want)),
            call_ms=cuda_ms(call), host_ms=_host_ms(call),
            device_ms=_device_ms(call, 50),
            library_call_ms=cuda_ms(lib), library_host_ms=_host_ms(lib),
            library_device_ms=_device_ms(lib, 50))
        del plan, dout, want
    torch.cuda.empty_cache()

    src_p = torch.as_tensor(products["edge_src"], device=dev)
    mask_p = torch.ones_like(dst_p, dtype=torch.bool)
    n = n_p
    plan = ops.segment_plan(dst_p, n, src=src_p, mask=mask_p)
    by_src = ops.source_plan(plan)
    for name, H, dd, dt, acc in (("l1", 8, 8, b16, f32),
                                 ("l2", 8, 7, b16, f32),
                                 ("l1_f32", 8, 8, f32, f32)):
        leaves = [torch.randn(shape, generator=gen, device=dev).to(dt)
                  .requires_grad_(True) for shape in ((n, H, dd), (n, H),
                                                      (n, H))]

        def fwd():
            return ops.gat_aggregate_ad(*leaves, plan, mask_p, acc,
                                        lambda: by_src)

        out = fwd()
        g = torch.randn(out.shape, generator=gen, device=dev).to(acc)

        def serve():
            with torch.no_grad():
                return ops.gat_aggregate(*leaves, plan, mask_p, acc)

        def bwd():
            return torch.autograd.grad(out, leaves, g, retain_graph=True)

        first = bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        again = bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        res[f"gat_bwd_{name}"] = dict(
            repeat_bit_equal=all(torch.equal(a, b)
                                 for a, b in zip(first, again)),
            finite=all(bool(torch.isfinite(a).all()) for a in first),
            call_ms=cuda_ms(bwd), device_ms=kernel_ms(bwd),
            fwd_call_ms=cuda_ms(fwd), fwd_serve_ms=cuda_ms(serve),
            bwd_peak_extra_bytes=peak)
        del leaves, out, g, first, again
        torch.cuda.empty_cache()
    for key, source in (("ptxas", kernel.BWD_SOURCE),
                        ("ptxas_fwd", kernel.SOURCE)):
        log = build.library_path(source).with_suffix(".log")
        res[key] = ([ln.strip() for ln in log.read_text().splitlines()
                     if any(w in ln for w in ("entry function", "registers",
                                               "spill"))]
                    if log.is_file() else [])
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
