"""Time every configuration of the bf16 conv kernels at config #2's shapes, on one CUDA card.

    python3 -m gentun_tpu_torch.tools.tune_pop_conv

Both bf16 kernels (``csrc/pop_conv3x3.cu``) have a few tile configurations,
and ``fwd_hop::pick`` and ``wg_hop::pick`` choose one from (C, F, H, W).

- Forward: for each conv call of config #2's train step (pop 20, batch 256:
  the forward and the input gradient of every layer) and of its eval forward
  (batch 1,024), every configuration on the same inputs (the weights laid
  out once beforehand).
- Weight gradient: for each conv of config #2's train step (6 shapes, 15
  calls a step), every configuration at the split ``pop_conv.wgrad_split``
  gives and at half and twice its images per split (the partials' buffers
  allocated once beforehand; the time includes the second pass).

Each is held against the plain version (``pop_conv3x3_reference``,
``pop_conv3x3_wgrad_reference``) at ``chip_smoke.TOLERANCE``'s bf16 share,
and its time printed by CUDA events (mean of 5 after one warm-up), the
picked one marked ``*``.  Prints one JSON line at the end.  Needs a CUDA
device; exits 2 without one, 1 if any configuration disagreed with the
plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys

NODES, FILTERS, POP = (3, 4, 5), (32, 64, 128), 20
TOL = 1e-2  # bf16 forward, as chip_smoke.TOLERANCE
TOL_WGRAD = 2e-2  # bf16 weight gradient, as chip_smoke.TOLERANCE


def shapes():
    """(name, role, shared, C, F, H, B) of each config #2 call."""
    out, h, c = [], 32, 3
    for s, f in enumerate(FILTERS):
        for layer, cin, shared in (("entry", c, s == 0), ("node", f, False)):
            name = f"stage{s}_{layer}"
            out.append((name, "fwd", shared, cin, f, h, 256))
            if not shared:
                out.append((name, "dgrad", False, f, cin, h, 256))
            out.append((name, "eval", shared, cin, f, h, 1024))
        h, c = h // 2, f
    return out


def wgrad_shapes():
    """(name, shared, C, F, H, B, calls a step) of each config #2 weight gradient."""
    out, h, c = [], 32, 3
    for s, (k, f) in enumerate(zip(NODES, FILTERS)):
        out.append((f"stage{s}_entry", s == 0, c, f, h, 256, 1))
        out.append((f"stage{s}_node", False, f, f, h, 256, k))
        h, c = h // 2, f
    return out


def _ms(torch, run) -> float:
    """Mean time of ``run()`` over 5 launches, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def tune_wgrad(torch, lib, dev, stream):
    """Every weight-gradient configuration and split at each config #2 shape;
    returns (rows, number of disagreements)."""
    from gentun_tpu_torch.ops import pop_conv

    rows, bad = [], 0
    for name, shared, c, f, h, b, calls in wgrad_shapes():
        g = torch.Generator(device=dev).manual_seed(c * 1000 + f)
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
        x = rnd(b, c, h, h) if shared else rnd(b, POP * c, h, h)
        dy = (rnd(b, POP * f, h, h).float() / (b * h * h) ** 0.5).to(torch.bfloat16)
        wshape = (POP, f, c, 3, 3)
        want = [t.double() for t in pop_conv.pop_conv3x3_wgrad_reference(x, dy, wshape, shared)]
        scale = max(float(t.abs().max()) for t in want)
        _, _, _, _, sstride, bstride = pop_conv._geometry(x, wshape, shared)
        picked = lib.gentun_pop_conv3x3_wgrad_bf16_pick(c, f, h, h)
        splits0, pps0 = pop_conv.wgrad_split(b, h, h, c, f, torch.bfloat16)
        ips0 = pps0 // (h * h)
        dw = torch.empty(wshape, dtype=torch.bfloat16, device=dev)
        db = torch.empty((POP, f), dtype=torch.bfloat16, device=dev)
        for ips in sorted({max(1, ips0 // 2), ips0, min(b, ips0 * 2)}):
            splits = -(-b // ips)
            part = torch.empty((POP, splits, f, c * 9), dtype=torch.float32, device=dev)
            dbpart = torch.empty((POP, splits, f), dtype=torch.float32, device=dev)
            row = {"layer": name, "C": c, "F": f, "H": h, "B": b, "calls": calls, "picked": picked,
                   "splits": splits, "rule_splits": splits0, "ms": {}, "rel_err": {}}
            for cfg in range(64):
                def run():
                    return lib.gentun_pop_conv3x3_wgrad_bf16_config(
                        cfg, x.data_ptr(), dy.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
                        dw.data_ptr(), db.data_ptr(), POP, b, c, f, h, h, splits, ips * h * h,
                        sstride, bstride, stream)

                dw.fill_(float("nan"))
                db.fill_(float("nan"))
                rc = run()
                if rc == -1:  # past the last configuration
                    break
                if rc:
                    row["ms"][cfg] = None
                    continue
                torch.cuda.synchronize()
                err = max(float((got.double() - w).abs().max()) for got, w in zip((dw, db), want))
                row["rel_err"][cfg] = err / scale
                bad += not err / scale <= TOL_WGRAD
                row["ms"][cfg] = _ms(torch, run)
            rows.append(row)
            cells = "  ".join(
                f"{k}{'*' if k == picked and splits == splits0 else ' '}:{v:8.3f}"
                if v is not None else f"{k} : refused" for k, v in row["ms"].items())
            print(f"wgrad {name:13s} C={c:3d} F={f:3d} {h:2d}x{h:<2d} B={b:4d} x{calls} "
                  f"splits={splits:3d}{'*' if splits == splits0 else ' '} {cells}  "
                  f"max err {max(row['rel_err'].values(), default=float('nan')):.2e}", flush=True)
    return rows, bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_pop_conv: no CUDA device", file=sys.stderr)
        return 2
    from gentun_tpu_torch.ops import _build, pop_conv

    lib = _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results, bad = [], 0
    for name, role, shared, c, f, h, b in shapes():
        g = torch.Generator(device=dev).manual_seed(c * 1000 + f)
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
        x = rnd(b, c, h, h) if shared else rnd(b, POP * c, h, h)
        w = (rnd(POP, f, c, 3, 3).float() / (9 * c) ** 0.5).to(torch.bfloat16)
        bias = rnd(POP, f) if role != "dgrad" else None
        want = pop_conv.pop_conv3x3_reference(x, w, bias, shared).double()
        scale = float(want.abs().max())
        _, _, _, _, sstride, bstride = pop_conv._geometry(x, w.shape, shared)
        picked = lib.gentun_pop_conv3x3_fwd_bf16_pick(c, f, h, h)
        row = {"layer": name, "role": role, "C": c, "F": f, "H": h, "B": b, "picked": picked,
               "ms": {}, "rel_err": {}}
        wk = pop_conv.tap_major(w)
        y = torch.empty((b, POP * f, h, h), dtype=torch.bfloat16, device=dev)
        for cfg in range(64):
            def run():
                return lib.gentun_pop_conv3x3_fwd_bf16_config(
                    cfg, x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
                    y.data_ptr(), POP, b, c, f, h, h, sstride, bstride, stream)

            y.fill_(float("nan"))
            rc = run()
            if rc == -1:  # past the last configuration
                break
            if rc:
                row["ms"][cfg] = None
                continue
            torch.cuda.synchronize()
            err = float((y.double() - want).abs().max()) / scale
            row["rel_err"][cfg] = err
            bad += err > TOL
            row["ms"][cfg] = _ms(torch, run)
        results.append(row)
        cells = "  ".join(
            f"{k}{'*' if k == picked else ' '}:{v:8.3f}" if v is not None else f"{k} : refused"
            for k, v in row["ms"].items())
        print(f"{name:13s} {role:5s} C={c:3d} F={f:3d} {h:2d}x{h:<2d} B={b:4d}  {cells}  "
              f"max err {max(row['rel_err'].values(), default=float('nan')):.2e}", flush=True)
    wrows, wbad = tune_wgrad(torch, lib, dev, stream)
    print(json.dumps({"card": smi, "rows": results, "wgrad_rows": wrows}))
    return 1 if bad or wbad else 0


if __name__ == "__main__":
    sys.exit(main())
