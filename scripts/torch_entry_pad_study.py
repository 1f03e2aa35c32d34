"""Padded entry conv on the card: does zero-padding the input channels pay?

The port's counterpart of ``scripts/entry_pad_study.py``.  The first conv of
stage 0 reads 3 input channels; ``entry_channel_pad`` zero-pads them at
data-prep level to 4 or 8 (the extra channels are all zero).  On the card
the forward kernel loads a pixel's channels in 16-byte chunks where a row
of channels is a whole chunk (bf16 C=8) and element by element where it is
not (C=3, C=4).

The variants are not the same training.  Initial weights are drawn per
parameter shape with the fan-in over the padded channels (``lecun_normal``
over C·9, as the reference draws them), so a padded entry conv starts from
other numbers, its real channels scaled by sqrt(3/C).  A variant's
accuracy is therefore held to the bench's own band for its schedule
(``ACC_GATE``: proxy ≥ 0.5, full > 0.9, as ``bench_torch.py`` and the
reference's study gate them), and its distance from the unpadded run is
recorded, not gated.

MFU accounting as in the reference: the numerator counts the UNPADDED
model's FLOPs for every variant, so a variant only scores higher if the card
ran the same useful work faster.  Each variant is timed by
``bench_torch.measure`` (the bench's own genomes and fence: a warm-up call,
then the median of ``--reps`` calls).

    python3 scripts/torch_entry_pad_study.py                   # full schedule
    python3 scripts/torch_entry_pad_study.py --schedule proxy
    python3 scripts/torch_entry_pad_study.py --tiny            # CPU smoke

Writes ``scripts/torch_entry_pad_study.json`` (incrementally: a failed later
variant keeps the earlier ones) with the card's name and power limit.  No
CUDA device and no ``--device cpu``/``--tiny``: exit 2.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (the bench workload IS the comparison baseline)

#: The accuracy band each variant's mean must clear, by schedule: the
#: bench's gates (``bench_torch.py``: proxy 0.5, full schedule 0.9).
ACC_GATE = {"proxy": 0.5, "full": 0.9, "tiny": 0.0}

TINY = dict(bench_torch.COMMON, kernels_per_layer=(4, 4, 4), dense_units=16, batch_size=32,
            compute_dtype="float32", kfold=2, epochs=(1,), learning_rate=(0.01,))
TINY_POP, TINY_N = 4, 160


def compare(x, y, base_cfg, pads, pop, mesh, reps=1, warmup=True, useful=None, n_cards=1):
    """Unpadded and ``entry_channel_pad=p`` for each of ``pads``: each
    variant's wall, rate, MFU on the unpadded FLOPs (``useful``; None on
    the CPU), accuracies and their distance from the unpadded run's.  Each
    is ``bench_torch.measure``'s workload and fence, reused so this study
    can never drift from the baseline it compares against."""
    out = {}
    base_accs = None
    for name, cfg in [("unpadded", dict(base_cfg))] + [
            (f"pad{p}", dict(base_cfg, entry_channel_pad=p)) for p in pads]:
        m = bench_torch.measure(x, y, cfg, pop=pop, mesh=mesh, reps=reps, warmup=warmup)
        accs, wall = np.asarray(m["accs"]), m["seconds"]
        if base_accs is None:
            base_accs = accs
        out[name] = {
            "wall_s": wall,
            "individuals_per_hour_per_chip": pop / wall * 3600.0 / max(n_cards, 1),
            "mfu_useful": (useful / wall / (bench_torch.PEAK_FLOPS * n_cards)
                           if useful and n_cards else None),
            "accuracy_mean": float(accs.mean()),
            "accuracy_mean_delta_vs_unpadded": float(accs.mean() - base_accs.mean()),
            "max_abs_accuracy_delta_vs_unpadded": float(np.abs(accs - base_accs).max()),
            "accs": [float(a) for a in accs],
        }
    base = out["unpadded"]["individuals_per_hour_per_chip"]
    for v in out.values():
        v["vs_unpadded"] = v["individuals_per_hour_per_chip"] / base
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pads", type=int, nargs="+", default=[4, 8],
                    help="entry_channel_pad values to compare against unpadded")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip each variant's warm-up call (the proxy pass, run first, "
                         "builds the kernels)")
    ap.add_argument("--schedule", choices=("full", "proxy"), default="full")
    ap.add_argument("--proxy-too", action="store_true",
                    help="also measure the proxy schedule (cheap, noisier), first")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="CPU smoke shapes (implies --device cpu)")
    ap.add_argument("--out", default=os.path.join(REPO, "scripts", "torch_entry_pad_study.json"))
    args = ap.parse_args(argv)
    cpu = args.tiny or args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("torch_entry_pad_study: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    mesh = "cpu" if cpu else "auto"
    n_cards = 0 if cpu else 1
    if args.tiny:
        from gentun_tpu_torch.utils.datasets import synthetic_images

        x, y, _ = synthetic_images(TINY_N, bench_torch.INPUT_SHAPE, bench_torch.N_CLASSES, seed=0)
        schedules, pop, n_data = [("tiny", TINY)], TINY_POP, TINY_N
    else:
        x, y = bench_torch.cifar_data()
        pop, n_data = bench_torch.POP, bench_torch.N_DATA
        full = bench_torch.FULL if args.schedule == "full" else bench_torch.PROXY
        schedules = ([("proxy", bench_torch.PROXY)] if args.proxy_too and full
                     is not bench_torch.PROXY else []) + [(args.schedule, full)]
    record = {
        "workload": f"bench_torch schedules {[s for s, _ in schedules]}, pop={pop}, "
                    "CIFAR-10 shape",
        "n_chips": n_cards,
        "card": bench_torch.card_line(cpu),
        "accuracy_gate": ACC_GATE,
        "reps": args.reps,
        "warmup": not args.no_warmup,
        "variants": {},
    }

    def flush():
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    failures = []
    for sched, cfg in schedules:
        useful = bench_torch.schedule_flops(cfg, pop, n_data) if not cpu else None
        res = compare(x, y, cfg, args.pads, pop, mesh, reps=args.reps,
                      warmup=not args.no_warmup or sched == "proxy", useful=useful,
                      n_cards=n_cards)
        for name, v in res.items():
            key = name if sched in (args.schedule, "tiny") else f"proxy_{name}"
            gate = ACC_GATE[sched]
            v[f"accuracy_gate_{gate}"] = bool(v["accuracy_mean"] > gate if sched == "full"
                                              else v["accuracy_mean"] >= gate)
            if not v[f"accuracy_gate_{gate}"]:
                failures.append(f"{key}: accuracy gate {gate} failed ({v['accuracy_mean']:.3f})")
            record["variants"][key] = v
            print(f"[{key}] wall={v['wall_s']:.3f}s rate={v['individuals_per_hour_per_chip']:.1f}"
                  f"/hr/card mfu={v['mfu_useful']} acc={v['accuracy_mean']:.4f} "
                  f"(Δ {v['accuracy_mean_delta_vs_unpadded']:+.4f}, max per genome "
                  f"{v['max_abs_accuracy_delta_vs_unpadded']:.4f})", flush=True)
        flush()
    record["failures"] = failures
    flush()
    print(f"wrote {args.out}")
    if failures:
        print("torch_entry_pad_study: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
