"""Time every configuration of the bf16 forward conv kernel at config #2's shapes, on one CUDA card.

    python3 -m gentun_tpu_torch.tools.tune_pop_conv

The bf16 forward kernel (``csrc/pop_conv3x3.cu``, ``fwd_hop``) has a few tile
configurations, and ``fwd_hop::pick`` chooses one from (C, F, H, W).  For
each conv call of config #2's train step (pop 20, batch 256: the forward and
the input gradient of every layer) and of its eval forward (batch 1,024),
this runs every configuration on the same inputs, holds each against the
plain version (``pop_conv3x3_reference``) at ``chip_smoke.TOLERANCE``'s bf16
share, and prints the kernel's time by CUDA events (mean of 5 after one
warm-up; the weights laid out once beforehand), the picked one marked.  Prints one JSON line at the end.  Needs a CUDA device;
exits 2 without one, 1 if any configuration disagreed with the plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys

NODES, FILTERS, POP = (3, 4, 5), (32, 64, 128), 20
TOL = 1e-2  # bf16 forward, as chip_smoke.TOLERANCE


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
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            row["ms"][cfg] = start.elapsed_time(end) / 5
        results.append(row)
        cells = "  ".join(
            f"{k}{'*' if k == picked else ' '}:{v:8.3f}" if v is not None else f"{k} : refused"
            for k, v in row["ms"].items())
        print(f"{name:13s} {role:5s} C={c:3d} F={f:3d} {h:2d}x{h:<2d} B={b:4d}  {cells}  "
              f"max err {max(row['rel_err'].values(), default=float('nan')):.2e}", flush=True)
    print(json.dumps({"card": smi, "rows": results}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
