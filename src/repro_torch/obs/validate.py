"""Validate ``--trace`` / ``--metrics`` artifacts: schema + invariants, the
counterpart of the reference package's validator (the same checks,
messages and exit codes; the schema names are artifact formats shared by
both packages, so each validator accepts the other's artifacts)::

    python -m repro_torch.obs.validate --trace t.json --metrics m.json \
        --cachescope c.json

Trace checks (Chrome trace event format):
  - top level is ``{"traceEvents": [...]}``
  - every event has ``name``/``ph``/``ts``/``pid``/``tid``; ``X``
    (complete) events also have ``dur >= 0``
  - per ``(pid, tid)`` lane, the ``X`` spans form a well-nested tree:
    any two spans are disjoint or one contains the other

Metric invariants (the cross-ledger accounting identities):
  - per rank and in total: ``local_reads + remote_reads == row_requests``
  - host-tier resolution is exhaustive: ``device_hits + cache_hits +
    cache_misses == remote_reads`` (hits + misses == row requests once
    local reads are netted out)
  - measured == modeled RMA traffic: when a ``CollectiveLedger`` was
    recorded, ``rma_rows_measured == rma_rows_modeled`` and
    ``rma_bytes_measured == rma_bytes_modeled`` (and the exported
    ``rma_agreement`` gauge is 1.0)
  - the placement gauges (``load_imbalance``, ``serve_matrix_skew``)
    are populated (> 0) whenever any rows were read

Cachescope checks (``--cachescope``, schema ``repro.obs.cachescope/v1``):
  - per stream: required keys, tier in {host_cache, device}, event
    arrays aligned
  - the replay-reconciliation invariant *recomputed from the raw
    events*: replaying the recorded trace under the deployed policy
    must reproduce the live stats deltas bit-exactly (host: gets/hits/
    misses/evictions/...; device: lookups/hits/misses/admits/evicts/
    patches) — not just trusting the stored ``reconciled`` flag
  - the stored Belady replay dominates every real policy's hits
  - Mattson spot checks (when present) all match direct simulation
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["validate_trace", "validate_metrics", "validate_cachescope",
           "main"]

_REQUIRED_EVENT_KEYS = ("name", "ph", "pid", "tid")


# --------------------------------------------------------------------------
# Trace
# --------------------------------------------------------------------------

def validate_trace(trace: dict) -> List[str]:
    """Return a list of violations (empty == valid)."""
    bad: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["top-level 'traceEvents' list missing"]
    lanes: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            bad.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        missing = [k for k in _REQUIRED_EVENT_KEYS if k not in ev]
        if ph != "M" and "ts" not in ev:  # metadata events carry no ts
            missing.append("ts")
        if missing:
            bad.append(f"event {i} ({ev.get('name')!r}): missing {missing}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"event {i} ({ev['name']!r}): bad dur {dur!r}")
                continue
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(dur), ev["name"])
            )
    for (pid, tid), spans in lanes.items():
        bad.extend(
            f"lane (pid={pid}, tid={tid}): {msg}"
            for msg in _check_nesting(spans)
        )
    return bad


def _check_nesting(spans: List[Tuple[float, float, str]]) -> List[str]:
    """Well-nestedness on one lane: sorted by (start, -length), each
    span must be fully inside whichever open span it starts under."""
    bad: List[str] = []
    stack: List[Tuple[float, float, str]] = []
    for t0, t1, name in sorted(spans, key=lambda s: (s[0], s[0] - s[1])):
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack and t1 > stack[-1][1]:
            bad.append(
                f"span {name!r} [{t0:.3f}, {t1:.3f}) overlaps "
                f"{stack[-1][2]!r} [{stack[-1][0]:.3f}, {stack[-1][1]:.3f})"
            )
            continue
        stack.append((t0, t1, name))
    return bad


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------

def _counter_total(snap: dict, name: str, *, rank: Optional[int] = None,
                   tier: Optional[str] = None,
                   phase: Optional[str] = None) -> float:
    return sum(
        row["value"] for row in snap.get("counters", [])
        if row["name"] == name
        and (rank is None or row["rank"] == rank)
        and (tier is None or row["tier"] == tier)
        and (phase is None or row["phase"] == phase)
    )


def _has_counter(snap: dict, name: str) -> bool:
    return any(row["name"] == name for row in snap.get("counters", []))


def _gauge(snap: dict, name: str, *, rank: int = -1) -> Optional[float]:
    for row in snap.get("gauges", []):
        if row["name"] == name and row["rank"] == rank:
            return row["value"]
    return None


def validate_metrics(snap: dict) -> List[str]:
    """Return a list of invariant violations (empty == valid)."""
    bad: List[str] = []
    if snap.get("schema") != "repro.obs.metrics/v1":
        return [f"unknown snapshot schema {snap.get('schema')!r}"]

    ranks = sorted({
        row["rank"] for row in snap.get("counters", [])
        if row["tier"] == "host" and row["rank"] >= 0
    })
    for scope in ([None] + ranks if ranks else [None]):
        local = _counter_total(snap, "local_reads", rank=scope, tier="host")
        remote = _counter_total(snap, "remote_reads", rank=scope, tier="host")
        requests = _counter_total(snap, "row_requests", rank=scope,
                                  tier="host")
        label = "total" if scope is None else f"rank {scope}"
        if local + remote != requests:
            bad.append(
                f"{label}: local_reads + remote_reads != row_requests "
                f"({local:g} + {remote:g} != {requests:g})"
            )
        hits = _counter_total(snap, "cache_hits", rank=scope, tier="host")
        misses = _counter_total(snap, "cache_misses", rank=scope, tier="host")
        dev = _counter_total(snap, "device_hits", rank=scope, tier="host")
        if hits + misses + dev != remote:
            bad.append(
                f"{label}: cache hits + misses (+device) != remote row "
                f"requests ({hits:g} + {misses:g} + {dev:g} != {remote:g})"
            )

    cache_ranks = sorted({
        row["rank"] for row in snap.get("counters", [])
        if row["tier"] == "host_cache" and row["rank"] >= 0
    })
    for scope in [None] + cache_ranks:
        gets = _counter_total(snap, "gets", rank=scope, tier="host_cache")
        h = _counter_total(snap, "hits", rank=scope, tier="host_cache")
        m = _counter_total(snap, "misses", rank=scope, tier="host_cache")
        if h + m != gets:
            label = "total" if scope is None else f"rank {scope}"
            bad.append(
                f"host_cache {label}: hits + misses != gets "
                f"({h:g} + {m:g} != {gets:g})"
            )

    # measured-vs-modeled applies only when reconciliation was recorded
    # (model and measurement covering the same traffic — query-serving
    # SPMD). A bare CollectiveLedger (streaming SPMD, whose loop-path
    # counterpart reads the store directly) makes no such claim.
    agreement = _gauge(snap, "rma_agreement")
    if agreement is not None:
        for dim in ("rows", "bytes"):
            measured = _counter_total(snap, f"rma_{dim}_measured",
                                      tier="wire")
            modeled = _counter_total(snap, f"rma_{dim}_modeled", tier="wire")
            if measured != modeled:
                bad.append(
                    f"rma_{dim}: measured {measured:g} != modeled "
                    f"{modeled:g}"
                )
        if agreement != 1.0:
            bad.append(f"rma_agreement gauge is {agreement:g}, expected 1.0")

    # placement gauges ship with every runtime-backed snapshot (the
    # epoch driver has no ShardedRuntime, hence no host tier — skip)
    if ranks or _has_counter(snap, "row_requests"):
        total_reads = _counter_total(snap, "row_requests", tier="host")
        for g in ("load_imbalance", "serve_matrix_skew"):
            v = _gauge(snap, g)
            if v is None:
                bad.append(f"gauge {g!r} missing")
            elif total_reads > 0 and not v > 0:
                bad.append(f"gauge {g!r} not populated ({v!r}) despite "
                           f"{total_reads:g} row requests")
    return bad


# --------------------------------------------------------------------------
# Cachescope sidecar
# --------------------------------------------------------------------------

_HOST_STREAM_KEYS = ("tier", "rank", "label", "config", "events", "live",
                     "replay", "reconciled", "analysis")
_HOST_EVENT_KEYS = ("kinds", "keys", "sizes", "scores", "hits")


def validate_cachescope(doc: dict) -> List[str]:
    """Return a list of violations (empty == valid). Recomputes the
    deployed-policy replay from the raw events instead of trusting the
    stored ``reconciled`` flag."""
    from .cachescope import (
        DEVICE_COMPARE,
        HOST_COMPARE,
        SCHEMA,
        replay_device,
        replay_host,
    )

    bad: List[str] = []
    if doc.get("schema") != SCHEMA:
        return [f"unknown cachescope schema {doc.get('schema')!r}"]
    streams = doc.get("streams")
    if not isinstance(streams, list):
        return ["top-level 'streams' list missing"]
    for i, s in enumerate(streams):
        label = f"stream {i} ({s.get('label')!r} r{s.get('rank')})"
        missing = [k for k in _HOST_STREAM_KEYS if k not in s]
        if missing:
            bad.append(f"{label}: missing keys {missing}")
            continue
        tier = s["tier"]
        if tier not in ("host_cache", "device"):
            bad.append(f"{label}: unknown tier {tier!r}")
            continue
        if tier == "host_cache":
            ev = s["events"]
            miss_ev = [k for k in _HOST_EVENT_KEYS if k not in ev]
            if miss_ev:
                bad.append(f"{label}: events missing {miss_ev}")
                continue
            n = len(ev["kinds"])
            if not (len(ev["keys"]) == len(ev["sizes"])
                    == len(ev["scores"]) == len(ev["hits"]) == n):
                bad.append(f"{label}: event arrays misaligned")
                continue
            recomputed = replay_host(s, policy="deployed")
            compare = HOST_COMPARE
        else:
            recomputed = replay_device(s)
            compare = DEVICE_COMPARE
        live = s["live"]
        diffs = [
            f"{k}: live {int(live.get(k, 0))} != replay "
            f"{int(recomputed.get(k, 0))}"
            for k in compare
            if int(live.get(k, 0)) != int(recomputed.get(k, 0))
        ]
        if diffs:
            bad.append(f"{label}: replay does not reconcile "
                       f"({'; '.join(diffs)})")
        if not s["reconciled"]:
            bad.append(f"{label}: stored reconciled flag is false")
        if tier == "host_cache":
            replay = s["replay"]
            bel = replay.get("belady")
            if bel is None:
                bad.append(f"{label}: belady replay missing")
            else:
                for pol, rep in replay.items():
                    if pol != "belady" and rep.get("hits", 0) > bel["hits"]:
                        bad.append(
                            f"{label}: policy {pol!r} beats belady "
                            f"({rep['hits']} > {bel['hits']})"
                        )
            spot = s["analysis"].get("spot_checks") or []
            for sc in spot:
                if not sc["match"]:
                    bad.append(
                        f"{label}: mattson/direct mismatch at capacity "
                        f"{sc['capacity_bytes']} ({sc['mattson_hits']} != "
                        f"{sc['direct_hits']})"
                    )
    summ = doc.get("summary", {})
    if summ.get("all_reconciled") is not True and not any(
        "reconcile" in m for m in bad
    ):
        bad.append("summary.all_reconciled is not true")
    return bad


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate repro --trace/--metrics artifacts"
    )
    ap.add_argument("--trace", default=None, help="Chrome trace JSON path")
    ap.add_argument("--metrics", default=None, help="metrics snapshot path")
    ap.add_argument("--cachescope", default=None,
                    help="cachescope sidecar (.cachescope.json) path")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics and not args.cachescope:
        ap.error(
            "nothing to validate: pass --trace, --metrics, or --cachescope"
        )

    violations: List[str] = []
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        v = validate_trace(trace)
        n_events = len(trace.get("traceEvents", []) or [])
        print(f"[validate] trace {args.trace}: {n_events} events, "
              f"{len(v)} violation(s)")
        violations += [f"trace: {m}" for m in v]
    if args.metrics:
        with open(args.metrics) as f:
            snap = json.load(f)
        v = validate_metrics(snap)
        print(f"[validate] metrics {args.metrics}: "
              f"{len(snap.get('counters', []))} counters, "
              f"{len(snap.get('gauges', []))} gauges, "
              f"{len(v)} violation(s)")
        violations += [f"metrics: {m}" for m in v]
    if args.cachescope:
        with open(args.cachescope) as f:
            doc = json.load(f)
        v = validate_cachescope(doc)
        n_streams = len(doc.get("streams", []) or [])
        print(f"[validate] cachescope {args.cachescope}: {n_streams} "
              f"stream(s), {len(v)} violation(s)")
        violations += [f"cachescope: {m}" for m in v]

    for m in violations:
        print(f"[validate]   FAIL {m}")
    print(f"[validate] {'FAIL' if violations else 'OK'}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
