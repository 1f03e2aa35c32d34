"""gentun-top: a refreshing terminal dashboard for the live ops plane.

Polls a master's or worker's ops server (``--ops-port`` /
``start_ops_server``, see docs/OBSERVABILITY.md "Live ops plane") and
renders ``/statusz`` + ``/healthz`` + ``/metrics`` as a top(1)-style
screen: health verdict, heartbeat ages, the broker's per-worker fleet
table, engine progress, and the headline counters.

    python scripts/torch_gentun_top.py --url http://127.0.0.1:8080
    python scripts/torch_gentun_top.py --url http://127.0.0.1:8080 --once

Fleet mode (docs/OBSERVABILITY.md "Fleet aggregation & SLOs"): point it
at a metrics aggregator instead of a single process and it renders the
whole search fleet — per-instance push table with a sparkline column
from the aggregator's time-series ring, active SLO alerts from
``/alertz``, the build/version-skew table, and the reset-corrected
fleet counter rollup:

    python scripts/torch_gentun_top.py --aggregator http://127.0.0.1:9100
    python scripts/torch_gentun_top.py --aggregator http://127.0.0.1:9100 \
        --spark worker_idle_s_sum

Stdlib only (urllib + ANSI escapes) — usable over ssh on the card's
host with nothing installed.  ``--once`` prints a single frame without touching
the screen (pipe-friendly); otherwise the screen redraws every
``--interval`` seconds until Ctrl-C.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

_CLEAR = "\x1b[2J\x1b[H"
_BOLD, _DIM, _RED, _GREEN, _YELLOW, _RESET = (
    "\x1b[1m", "\x1b[2m", "\x1b[31m", "\x1b[32m", "\x1b[33m", "\x1b[0m")

#: Counters worth a line on the dashboard, in display order (the full
#: registry instrument set — see docs/OBSERVABILITY.md metric catalog).
_HEADLINE_COUNTERS = (
    "device_seconds_total",
    "stragglers_detected_total",
    "stragglers_requeued_total",
    "population_cache_hits_total",
    "population_dedup_collapsed_total",
    "population_speculative_total",
    "faults_injected_total",
    "fitness_service_hits_total",
    "fitness_service_misses_total",
    "fitness_service_evictions_total",
    "compile_cache_hits_total",
    "compile_cache_misses_total",
    "compile_cache_publishes_total",
    "compile_cache_evictions_total",
    "worker_drains_total",
    "session_rejected_total",
    "session_quarantined_total",
    "eval_pad_waste_total",
    "preemptions_total",
)


def _fmt_mesh(mesh):
    """'8×1' for a host-mesh worker's {pop, data} advertisement, '-' else."""
    if not isinstance(mesh, dict):
        return "-"
    return f"{mesh.get('pop', '?')}x{mesh.get('data', '?')}"


def _get(url: str, timeout: float):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _fetch(base: str, timeout: float):
    """(healthz, statusz, metrics_text) — None for anything unreachable."""
    try:
        _, hz = _get(base + "/healthz", timeout)
        _, sz = _get(base + "/statusz", timeout)
        _, mx = _get(base + "/metrics", timeout)
        return json.loads(hz), json.loads(sz), mx.decode("utf-8")
    except (urllib.error.URLError, OSError, ValueError) as e:
        return None, None, str(e)


def _parse_counters(metrics_text: str):
    """name -> summed value across label sets (enough for headlines)."""
    totals = {}
    for line in metrics_text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(" ", 1)
            name = name_part.split("{", 1)[0]
            totals[name] = totals.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return totals


def _parse_labeled(metrics_text: str, name: str, label: str):
    """``name{..., label="x", ...} value`` -> {x: summed value} — the
    per-label slice the headline sum above flattens away (the wire panel
    needs per-frame-type series, not one total)."""
    out = {}
    prefix = name + "{"
    for line in metrics_text.splitlines():
        if not line.startswith(prefix):
            continue
        try:
            labels_part, value = line.rsplit(" ", 1)
            pairs = (kv.split("=", 1) for kv in
                     labels_part[len(prefix):].rstrip("}").split(","))
            labels = {k: v.strip('"') for k, v in pairs}
            key = labels.get(label)
            if key is not None:
                out[key] = out.get(key, 0.0) + float(value)
        except ValueError:
            continue
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GB"


def _fmt_age(age):
    if age is None:
        return "-"
    return f"{age:.1f}s"


def render(base: str, healthz, statusz, metrics_text, color: bool) -> str:
    B, D, R, G, Y, X = ((_BOLD, _DIM, _RED, _GREEN, _YELLOW, _RESET)
                        if color else ("",) * 6)
    lines = []
    if healthz is None:
        lines.append(f"{R}gentun-top: {base} unreachable{X} ({metrics_text})")
        return "\n".join(lines)

    ok = healthz.get("status") == "ok"
    verdict = f"{G}HEALTHY{X}" if ok else f"{R}UNHEALTHY{X}"
    lines.append(f"{B}gentun-top{X}  {base}  [{verdict}]  "
                 f"up {statusz.get('uptime_s', 0):.0f}s  pid {statusz.get('pid')}")
    for reason in healthz.get("reasons", []):
        lines.append(f"  {R}! {reason}{X}")

    hbs = statusz.get("heartbeats", {})
    if hbs:
        lines.append(f"{B}heartbeats{X}")
        for name, hb in hbs.items():
            mark = f"{R}STALE{X}" if hb.get("stale") else f"{G}ok{X}"
            gate = f"gate {hb['timeout_s']}s" if hb.get("timeout_s") else "advisory"
            lines.append(f"  {name:<20} {_fmt_age(hb.get('age_s')):>8}  "
                         f"{mark}  {D}{gate}{X}")

    eng = statusz.get("engine")
    if eng:
        # With several searches on one broker the "engine" block is a
        # {"mode": "multi", "sessions": {...}} map — one line per tenant.
        engines = (eng.get("sessions", {}) if eng.get("mode") == "multi"
                   else {eng.get("session", "default"): eng})
        for sid, e in engines.items():
            if not isinstance(e, dict):
                lines.append(f"{B}engine{X} [{sid}]  {R}{e}{X}")
                continue
            if e.get("mode") == "async":
                prog = (f"completed {e.get('completed')}/{e.get('dispatched')} "
                        f"in-flight {e.get('in_flight')} queued {e.get('queued')}")
            else:
                prog = (f"generation {e.get('generation')} "
                        f"pop {e.get('population_size')}")
            lines.append(f"{B}engine{X} [{e.get('mode', '?')}:{sid}]  {prog}  "
                         f"best {e.get('best_fitness')}  "
                         f"{D}trace {e.get('trace_id')}{X}")
            sur = e.get("surrogate")
            if sur:
                # Surrogate rung −1 panel (DISTRIBUTED.md): is the gate
                # trained, what fraction of bred children it vetoes, and
                # whether the dataset-plane sync is degraded (admit-all).
                total = (sur.get("admitted", 0) or 0) + (sur.get("rejected", 0) or 0)
                veto = (100.0 * sur.get("rejected", 0) / total) if total else 0.0
                model = (f"{G}trained{X}" if sur.get("trained")
                         else f"{Y}warming{X}")
                prec = sur.get("precision_at_k")
                prec_s = f"{prec:.2f}" if prec is not None else "-"
                degraded = (f"  {R}DEGRADED (admit-all){X}"
                            if sur.get("degraded") else "")
                lines.append(
                    f"{B}surrogate{X} [{sid}]  {model}  "
                    f"admit {sur.get('admitted')} veto {sur.get('rejected')} "
                    f"({veto:.0f}%)  pending {sur.get('pending')}  "
                    f"refits {sur.get('refits')}  p@k {prec_s}"
                    f"{degraded}")

    fleet = statusz.get("fleet")
    if fleet:
        # Live-membership panel (elastic fleet): how many workers are
        # connected right now, how many are on their way out, and the
        # dispatch window the engine's in-flight target follows.
        members = fleet.get("members")
        membership = ""
        if members is not None:
            draining = fleet.get("draining", 0)
            preemptible = fleet.get("preemptible_members", 0)
            membership = (f"members {members}"
                          + (f" ({Y}{draining} draining{X})" if draining else "")
                          + (f" ({preemptible} preemptible)" if preemptible
                             else "")
                          + f"  window {fleet.get('live_capacity', '-')}"
                          f"+{fleet.get('live_prefetch', '-')}  ")
        lines.append(
            f"{B}fleet{X}  {membership}queue {fleet.get('queue_depth')}  "
            f"open {fleet.get('open_jobs')}  in-flight {fleet.get('jobs_in_flight')}  "
            f"straggler-threshold {fleet.get('straggler_threshold_s')}s"
            + ("  requeue on" if fleet.get("straggler_requeue") else ""))
        workers = fleet.get("workers", [])
        if workers:
            lines.append(f"  {D}{'worker':<16}{'cap':>4}{'pre':>4}{'credit':>7}"
                         f"{'busy':>5}{'chips':>6}{'mesh':>7}{'seen':>8}  backend{X}")
            for w in workers:
                lines.append(
                    f"  {str(w.get('worker_id', '?'))[:16]:<16}"
                    f"{w.get('capacity', '-'):>4}"
                    f"{w.get('prefetch_depth', '-'):>4}"
                    f"{w.get('credit', '-'):>7}"
                    f"{w.get('jobs_in_flight', '-'):>5}"
                    f"{w.get('n_chips', '-'):>6}"
                    f"{_fmt_mesh(w.get('mesh')):>7}"
                    f"{_fmt_age(w.get('last_seen_age_s')):>8}  "
                    f"{w.get('backend') or '-'}"
                    + (f"  {Y}v1-wire{X}" if w.get("wire_caps") == [] else "")
                    + (f"  {D}PRE{X}" if w.get("preemptible") else "")
                    # Multi-homed workers (horizontal sharding): this
                    # shard sees the worker's FULL window, so divide the
                    # capacity sums by ×N before totaling a campus.
                    + (f"  {D}×{w['homes']}-homed{X}"
                       if w.get("homes", 1) > 1 else "")
                    + (f"  {Y}DRAINING{X}" if w.get("draining") else ""))
        for s in fleet.get("stragglers", []):
            lines.append(f"  {Y}~ straggler {s['job_id']} on {s['worker_id']} "
                         f"({s['age_s']}s > {s['threshold_s']}s){X}")
        sessions = fleet.get("sessions")
        if sessions:
            # Per-tenant panel (multi-tenant sessions): who is getting the
            # fleet, who is throttled by quota, who is quarantining genomes.
            lines.append(f"  {D}{'session':<16}{'wt':>5}{'done':>7}{'fly':>5}"
                         f"{'queue':>7}{'quota':>7}{'quar':>6}{'rej':>5}{X}")
            for sid in sorted(sessions):
                s = sessions[sid]
                quota = s.get("max_in_flight")
                lines.append(
                    f"  {str(sid)[:16]:<16}"
                    f"{s.get('weight', 1):>5g}"
                    f"{s.get('completed', 0):>7}"
                    f"{s.get('in_flight', 0):>5}"
                    f"{s.get('queued', 0):>7}"
                    f"{quota if quota is not None else '-':>7}"
                    f"{s.get('quarantined', 0):>6}"
                    f"{s.get('rejected', 0):>5}"
                    + (f"  {Y}CLOSED{X}" if s.get("closed") else ""))
        jrn = fleet.get("journal")
        if jrn:
            # Crash-safety panel (DISTRIBUTED.md "Broker crash safety &
            # admission control"): boot epoch, journal volume, fsync
            # recency, and what the last replay cost — the restart story
            # at a glance.  Absent ⇔ journaling off.
            recs = jrn.get("records_total") or {}
            hot = "  ".join(f"{t}={recs[t]}" for t in ("sub", "d", "c", "q")
                            if recs.get(t))
            replay = jrn.get("replay_seconds")
            lines.append(
                f"{B}journal{X}  epoch {fleet.get('epoch')}  "
                f"restarts {fleet.get('restarts', 0)}  "
                f"records {sum(recs.values())}"
                + (f" ({hot})" if hot else "")
                + f"  buffered {jrn.get('records_buffered', 0)}"
                + f"  fsync-lag {jrn.get('last_fsync_lag_s', '-')}s"
                + (f"  replay {replay * 1e3:.0f}ms" if replay else "")
                + (f"  {Y}WEDGED{X}" if jrn.get("wedged") else ""))
        adm = fleet.get("admission") or {}
        rejected = adm.get("rejected_by_session") or {}
        if rejected:
            # Per-tenant admission rejections: who is being turned away
            # (429-style errors with retry_after_s), loudest first.
            top = ", ".join(f"{sid}={n}" for sid, n in
                            sorted(rejected.items(),
                                   key=lambda kv: -kv[1])[:4])
            knobs = "  ".join(
                f"{k} {v}" for k, v in (("rate", adm.get("rate")),
                                        ("burst", adm.get("burst")),
                                        ("queue-factor",
                                         adm.get("queue_factor")))
                if v is not None)
            lines.append(f"  {Y}admission rejected: {top}{X}"
                         + (f"  {D}{knobs}{X}" if knobs else ""))

    worker = statusz.get("worker")
    if worker:
        lines.append(f"{B}worker{X}  {worker.get('worker_id')}  "
                     f"cap {worker.get('capacity')}  "
                     f"done {worker.get('jobs_done')}  "
                     f"{'connected' if worker.get('connected') else 'DISCONNECTED'}"
                     + (f"  {Y}DRAINING{X}" if worker.get("draining") else ""))
        homes = worker.get("homes")
        if homes:
            # Per-shard panel (DISTRIBUTED.md "Horizontal broker
            # sharding"): one row per home of a multi-homed worker — the
            # per-shard link health a single "connected" flag flattens.
            lines.append(f"  {D}{'shard':<22}{'link':>6}  boot{X}")
            for h in homes:
                link = (f"{R}DEAD{X}" if h.get("dead")
                        else (f"{G}up{X}" if h.get("connected")
                              else f"{Y}down{X}"))
                lines.append(
                    f"  {str(h.get('shard', '?'))[:22]:<22}{link:>6}  "
                    f"{h.get('boot_id') or '-'}"
                    + (f"  {Y}v1-wire{X}"
                       if h.get("wire_caps_granted") == [] else ""))

    # Router shard panel (sharded master): per-shard session homes from
    # the shard_sessions gauge, plus placement churn — present only when
    # a ShardRouter runs in this process.
    shard_sessions = _parse_labeled(metrics_text or "", "shard_sessions",
                                    "shard")
    if shard_sessions:
        moved = _parse_counters(metrics_text or "").get(
            "shard_rebalances_total", 0)
        per = "  ".join(f"{s}={shard_sessions[s]:g}"
                        for s in sorted(shard_sessions))
        lines.append(f"{B}shards{X}  {len(shard_sessions)} in ring  "
                     f"sessions {per}"
                     + (f"  {Y}rebalanced {moved:g}{X}" if moved else ""))

    # Mesh panel (host-level mesh workers, DISTRIBUTED.md): the local
    # evaluation mesh's axis sizes — from the worker's /statusz block when
    # available (includes the device count capacity derives from), else
    # from the mesh_* gauges any mesh-sharded evaluator sets — plus the
    # cumulative padding-slot waste counter the aligned dispatch schedule
    # is supposed to hold at zero.
    totals = _parse_counters(metrics_text or "")
    mesh = (worker or {}).get("mesh")
    if mesh or "mesh_pop_axis" in totals:
        if mesh:
            shape = (f"pop {mesh.get('pop')} × data {mesh.get('data')}  "
                     f"devices {mesh.get('devices', '-')}"
                     + ("  (capacity derived)" if mesh.get("derived_capacity") else ""))
        else:
            shape = (f"pop {totals['mesh_pop_axis']:g} × "
                     f"data {totals.get('mesh_data_axis', 1):g}")
        waste = totals.get("eval_pad_waste_total", 0)
        wcol = f"{R}{waste:g}{X}" if waste else f"{G}0{X}"
        lines.append(f"{B}mesh{X}  {shape}  pad-waste {wcol}")

    # Shared fitness-cache panel: the "fitness_service" status provider is
    # registered by whichever side runs a FitnessServiceClient (master via
    # cache_url=, worker via --cache-url → client _ops_status block).
    cache = statusz.get("fitness_service") or (worker or {}).get("fitness_service")
    if cache:
        rate = cache.get("hit_rate")
        state = (f"{R}DEGRADED (local-only){X}" if cache.get("degraded")
                 else f"{G}connected{X}")
        lines.append(f"{B}fitness cache{X}  {cache.get('url')}  {state}  "
                     f"hits {cache.get('hits')}  misses {cache.get('misses')}  "
                     f"hit-rate {'-' if rate is None else f'{rate:.1%}'}  "
                     f"pending-publish {cache.get('pending_publish')}  "
                     f"local {cache.get('local_entries', '-')}")

    # Compile-cache panel: the fleet-wide executable cache
    # (distributed/compile_service.py).  Workers started with
    # --compile-cache-url surface their client block in _ops_status;
    # "fetched" artifacts are compiles this worker skipped, while
    # "compiled local" are shapes it paid for and published to the fleet.
    cc = statusz.get("compile_cache") or (worker or {}).get("compile_cache")
    if cc:
        state = (f"{R}DEGRADED (local compiles){X}" if cc.get("degraded")
                 else f"{G}connected{X}")
        fp = cc.get("fingerprint")
        lines.append(f"{B}compile cache{X}  {cc.get('url')}  {state}  "
                     f"fetched {cc.get('fetched')}  "
                     f"compiled-local {cc.get('compiled_local')}  "
                     f"published {cc.get('published')}  "
                     f"pending-publish {cc.get('pending_publish')}  "
                     f"{D}platform {fp if fp else '-'}{X}")

    # Wire panel (DISTRIBUTED.md "Wire fast path"): per-frame-type send
    # volume from this end's wire counters (a jobs2 series means the fast
    # path negotiated; its bytes/frame vs jobs is the hoist's saving), the
    # sampled frame-encode cost, and the broker's fragment-cache hit rate.
    wf = _parse_labeled(metrics_text or "", "wire_frames_sent_total", "type")
    if wf:
        wb = _parse_labeled(metrics_text or "", "wire_bytes_sent_total", "type")
        parts = [f"{t} {wf[t]:g}/{_fmt_bytes(wb.get(t, 0))}"
                 for t in sorted(wf, key=lambda t: -wb.get(t, 0))]
        enc_sum = _parse_labeled(metrics_text or "", "frame_encode_seconds_sum",
                                 "side")
        enc_n = _parse_labeled(metrics_text or "", "frame_encode_seconds_count",
                               "side")
        enc = "  ".join(f"{D}enc[{s}] ~{enc_sum[s] / n * 1e6:.0f}us{X}"
                        for s, n in sorted(enc_n.items()) if n)
        lines.append(f"{B}wire{X}  " + "  ".join(parts)
                     + (f"  {enc}" if enc else ""))
        frag = (statusz.get("fleet") or {}).get("fragment_cache")
        if frag:
            lookups = (frag.get("hits", 0) or 0) + (frag.get("misses", 0) or 0)
            rate = f"{frag['hits'] / lookups:.1%}" if lookups else "-"
            lines.append(f"  {D}fragment cache: {frag.get('entries')} genomes, "
                         f"hit-rate {rate} "
                         f"({frag.get('hits')}/{lookups} lookups){X}")

    # Packing panel (DISTRIBUTED.md "Cross-session window packing"):
    # present only when the broker runs pack_windows=True — window/job
    # totals, the cross-session share (the whole point: >0 means tenants
    # are actually amortizing the program-switch floor together), fill
    # and linger percentiles from the pack plane, and the per-session
    # packed-job split from the metrics counters.
    packing = (statusz.get("fleet") or {}).get("packing")
    if packing:
        wt = packing.get("windows_total", 0) or 0
        xs = packing.get("cross_session_windows", 0) or 0
        share = f"{xs / wt:.0%}" if wt else "-"
        fill = packing.get("fill_ratio") or {}
        lng = packing.get("linger_s") or {}
        lines.append(
            f"{B}packing{X}  windows {wt} ({xs} cross-session, {share})  "
            f"jobs {packing.get('jobs_total', 0)}  "
            f"held {packing.get('held', 0)}/{packing.get('groups', 0)}g  "
            f"linger-cap {packing.get('linger_ms', 0):g}ms")
        if fill or lng:
            lines.append(
                f"  {D}fill p50 {fill.get('p50', 0):.2f} "
                f"p90 {fill.get('p90', 0):.2f}  "
                f"linger p50 {lng.get('p50', 0) * 1e3:.1f}ms "
                f"p90 {lng.get('p90', 0) * 1e3:.1f}ms{X}")
        pj = _parse_labeled(metrics_text or "", "packed_jobs_total", "session")
        if pj:
            parts = [f"{s or 'default'} {n:g}"
                     for s, n in sorted(pj.items(), key=lambda kv: -kv[1])]
            lines.append(f"  {D}packed jobs by session: "
                         f"{'  '.join(parts[:6])}{X}")

    # Chip-hour cost panel (search forensics, docs/OBSERVABILITY.md): the
    # "cost" status provider exists only while the lineage plane is on —
    # measured device-seconds from the cost ledger, attributed to
    # (session, genome, rung, worker), rolled up here per axis.
    cost = statusz.get("cost") or (worker or {}).get("cost")
    if cost:
        total_s = cost.get("device_s_total", 0) or 0
        rungs = "  ".join(f"r{r}={s:.1f}s" for r, s in
                          sorted((cost.get("by_rung") or {}).items()))
        lines.append(f"{B}cost{X}  device {total_s:.1f}s "
                     f"({total_s / 3600:.4f} chip-h)  "
                     f"genomes {cost.get('genomes', '-')}"
                     + (f"  {D}{rungs}{X}" if rungs else ""))
        for axis in ("by_session", "by_worker"):
            cells = cost.get(axis) or {}
            if cells:
                top = sorted(cells.items(), key=lambda kv: -kv[1])[:4]
                lines.append(f"  {D}{axis[3:]}:{X}  " + "  ".join(
                    f"{k}={s:.1f}s" for k, s in top)
                    + (f"  {D}(+{len(cells) - 4} more){X}"
                       if len(cells) > 4 else ""))

    # Autoscaler / placement panel (DISTRIBUTED.md "Autoscaling &
    # preemptible capacity"): target vs actual fleet size, decisions by
    # direction and triggering rule, and reclaim volume.  Series exist
    # only where the daemon's registry is scraped (in-process daemon, or
    # a fleet view through the aggregator) — absent ⇔ no autoscaler.
    if "autoscaler_decisions_total" in totals or "fleet_target_size" in totals:
        by_action = _parse_labeled(metrics_text or "",
                                   "autoscaler_decisions_total", "action")
        by_rule = _parse_labeled(metrics_text or "",
                                 "autoscaler_decisions_total", "rule")
        rules = "  ".join(f"{r}={v:g}" for r, v in
                          sorted(by_rule.items(), key=lambda kv: -kv[1]))
        lines.append(
            f"{B}autoscaler{X}  target {totals.get('fleet_target_size', '-'):g}"
            f"  up {by_action.get('up', 0):g}  down {by_action.get('down', 0):g}"
            + (f"  {D}{rules}{X}" if rules else "")
            + (f"  preemptions {totals['preemptions_total']:g}"
               if totals.get("preemptions_total") else ""))

    headline = [(n, totals[n]) for n in _HEADLINE_COUNTERS if n in totals]
    if headline:
        lines.append(f"{B}counters{X}  " + "  ".join(
            f"{n.replace('_total', '')}={v:g}" for n, v in headline))
    return "\n".join(lines)


#: Unicode eighth-blocks for the ring sparklines, lowest to highest.
_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 16) -> str:
    """Render a value series as a fixed-width unicode sparkline.

    The last ``width`` samples, min-max normalised; a flat series renders
    as a run of the lowest block rather than noise.
    """
    vals = [float(v) for v in values][-width:]
    if not vals:
        return "-" * 1
    lo, hi = min(vals), max(vals)
    if hi - lo <= 1e-12:
        return _SPARK_CHARS[0] * len(vals)
    scale = (len(_SPARK_CHARS) - 1) / (hi - lo)
    return "".join(_SPARK_CHARS[int((v - lo) * scale)] for v in vals)


def _ring_deltas(points, counter: bool):
    """Ring ``[[t, v], ...]`` → plottable values (counters as increments)."""
    vals = [p[1] for p in points]
    if not counter or len(vals) < 2:
        return vals
    return [max(0.0, b - a) for a, b in zip(vals, vals[1:])]


def _fetch_agg(base: str, timeout: float, spark: str):
    """(statusz, alertz, ringz, metrics_text) from an aggregator."""
    try:
        _, sz = _get(base + "/statusz", timeout)
        _, az = _get(base + "/alertz", timeout)
        _, rz = _get(base + f"/ringz?name={urllib.parse.quote(spark)}", timeout)
        _, mx = _get(base + "/metrics", timeout)
        return json.loads(sz), json.loads(az), json.loads(rz), mx.decode("utf-8")
    except (urllib.error.URLError, OSError, ValueError) as e:
        return None, None, None, str(e)


def render_fleet(base: str, statusz, alertz, ringz, metrics_text,
                 spark: str, color: bool) -> str:
    """One frame of the fleet dashboard (aggregator mode)."""
    B, D, R, G, Y, X = ((_BOLD, _DIM, _RED, _GREEN, _YELLOW, _RESET)
                        if color else ("",) * 6)
    lines = []
    if statusz is None:
        lines.append(f"{R}gentun-top: aggregator {base} unreachable{X} "
                     f"({metrics_text})")
        return "\n".join(lines)

    lines.append(
        f"{B}gentun-top [fleet]{X}  {base}  up {statusz.get('uptime_s', 0):.0f}s  "
        f"instances {statusz.get('instances')}  series {statusz.get('series')}  "
        f"pushes {statusz.get('pushes')} "
        f"({statusz.get('pushes_dropped')} dropped, "
        f"{statusz.get('resets_detected')} resets)")

    # Active SLO alerts first — this is the pane the dashboard exists for.
    active = (alertz or {}).get("active") or []
    if active:
        for a in active:
            sev = a.get("severity", "ticket")
            mark = f"{R}PAGE{X}" if sev == "page" else f"{Y}{sev}{X}"
            val = a.get("value")
            lines.append(
                f"  {mark} {B}{a.get('rule')}{X} [{a.get('subject')}] "
                f"value {val if val is None else f'{val:.4g}'}  "
                f"{D}{a.get('description', '')}{X}")
    else:
        lines.append(f"  {G}no active alerts{X}  "
                     f"{D}(fired {statusz.get('alerts_fired', 0)} / "
                     f"cleared {statusz.get('alerts_cleared', 0)} lifetime){X}")

    # Per-instance sparkline data: the requested series from the ring,
    # counters plotted as per-push increments so activity reads as bumps.
    sparks = {}
    counterish = spark.endswith("_total") or spark.endswith("_count")
    for s in (ringz or {}).get("series", []):
        inst = (s.get("labels") or {}).get("instance")
        if inst and s.get("points"):
            vals = _ring_deltas(s["points"], counterish)
            # Several label sets per instance collapse onto one lane.
            prev = sparks.get(inst)
            if prev and len(prev) == len(vals):
                vals = [a + b for a, b in zip(prev, vals)]
            sparks[inst] = vals

    table = statusz.get("instance_table") or []
    if table:
        lines.append(f"{B}instances{X}  {D}spark: {spark}{X}")
        lines.append(f"  {D}{'instance':<24}{'role':<16}{'series':>7}"
                     f"{'pushes':>7}{'seen':>8}  trend{X}")
        for i in sorted(table, key=lambda i: (i.get("role", ""),
                                              i.get("instance", ""))):
            inst = i.get("instance", "?")
            stale = (f"  {R}STALE{X}" if i.get("stale") else "")
            lines.append(
                f"  {str(inst)[:24]:<24}{str(i.get('role', '?'))[:16]:<16}"
                f"{i.get('n_series', '-'):>7}{i.get('pushes', '-'):>7}"
                f"{_fmt_age(i.get('age_s')):>8}  "
                f"{_sparkline(sparks.get(inst, []))}{stale}")

    skew = statusz.get("version_skew") or {}
    builds = skew.get("builds") or []
    if builds:
        head = (f"{R}VERSION SKEW{X}" if skew.get("skew")
                else f"{G}uniform{X}")
        lines.append(f"{B}builds{X}  {head}")
        for b in builds:
            members = b.get("instances", [])
            desc = "  ".join(f"{k}={v}" for k, v in sorted(b.items())
                             if k != "instances")
            lines.append(f"  {desc}  {D}({len(members)}: "
                         f"{', '.join(members[:4])}"
                         f"{'…' if len(members) > 4 else ''}){X}")

    fleet = statusz.get("fleet") or {}
    counters = fleet.get("counters") or {}
    headline = [(n, counters[n]) for n in _HEADLINE_COUNTERS if n in counters]
    if headline:
        lines.append(f"{B}fleet counters{X}  " + "  ".join(
            f"{n.replace('_total', '')}={v:g}" for n, v in headline))
    gauges = fleet.get("gauges") or {}
    interesting = [(n, v) for n, v in sorted(gauges.items())
                   if n.startswith(("engine_", "session_queue_depth",
                                    "fleet_target_size",
                                    "preemptible_members"))]
    if interesting:
        lines.append(f"{B}fleet gauges{X}  " + "  ".join(
            f"{n}={v:g}" for n, v in interesting))

    # Canary panel (docs/OBSERVABILITY.md "Canary plane"): the black-box
    # verdict — golden-genome probes through the real serving path.
    # Present only when a canary daemon is pushing.  Non-zero drift is
    # PAGE-red: the fleet returned a wrong answer for a known genome.
    probes = _parse_labeled(metrics_text or "", "canary_probes_total",
                            "result")
    if probes or any(n.startswith("canary_") for n in counters):
        mc = _parse_counters(metrics_text or "")
        drift = counters.get("canary_fitness_drift_total", 0.0)
        errors = counters.get("canary_errors_total", 0.0)
        e2e_n = mc.get("canary_e2e_seconds_count", 0.0)
        e2e = (f"~{mc.get('canary_e2e_seconds_sum', 0.0) / e2e_n:.2f}s"
               if e2e_n else "-")
        ttfd_n = mc.get("canary_ttfd_seconds_count", 0.0)
        ttfd = (f"~{mc.get('canary_ttfd_seconds_sum', 0.0) / ttfd_n * 1e3:.0f}ms"
                if ttfd_n else "-")
        verdict = (f"{R}DRIFT ×{drift:g}{X}" if drift
                   else f"{G}bit-clean{X}")
        lines.append(
            f"{B}canary{X}  {verdict}  "
            f"probes {sum(probes.values()):g} "
            f"(ok {probes.get('ok', 0):g}, drift {probes.get('drift', 0):g}, "
            f"error {probes.get('error', 0):g})  e2e {e2e}  ttfd {ttfd}  "
            f"goldens {gauges.get('canary_goldens_sealed', 0):g}")
        if errors:
            stages = _parse_labeled(metrics_text or "", "canary_errors_total",
                                    "stage")
            lines.append(f"  {D}errors by stage: " + "  ".join(
                f"{s} {n:g}" for s, n in sorted(stages.items(),
                                                key=lambda kv: -kv[1]))
                + f"{X}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python scripts/torch_gentun_top.py",
        description="terminal dashboard for a gentun_tpu_torch ops server")
    ap.add_argument("--url", default="http://127.0.0.1:8080",
                    help="ops server base URL (the --ops-port address)")
    ap.add_argument("--aggregator", metavar="URL", default=None,
                    help="fleet mode: a metrics aggregator base URL "
                         "(telemetry/aggregator.py); renders the whole "
                         "fleet instead of one process")
    ap.add_argument("--spark", default="device_seconds_total",
                    help="series name for the instance-table sparkline "
                         "column (fleet mode; counters plot increments)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    ap.add_argument("--timeout", type=float, default=3.0,
                    help="per-request timeout in seconds")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    if args.interval <= 0:
        raise SystemExit(f"--interval must be positive, got {args.interval}")
    base = (args.aggregator or args.url).rstrip("/")
    color = not args.no_color and (args.once or sys.stdout.isatty())

    def frame_once() -> str:
        if args.aggregator:
            return render_fleet(base, *_fetch_agg(base, args.timeout, args.spark),
                                spark=args.spark, color=color)
        return render(base, *_fetch(base, args.timeout), color=color)

    if args.once:
        print(frame_once())
        return 0
    try:
        while True:
            frame = frame_once()
            sys.stdout.write(_CLEAR + frame + "\n" +
                             f"{_DIM}refresh {args.interval}s — Ctrl-C to quit{_RESET}\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
