"""W3C PROV-style lineage over deterministic span traces.

``prov_records`` materializes entity / activity / agent records plus
the four relations (wasGeneratedBy, used, wasDerivedFrom,
wasAttributedTo) from a span stream (``teamllm.spans`` /
``serving.tracing``): the final answer chains back through the judge
to the route decision, the route decision to the probe sample set,
each ensemble member's answer to its launch, and KV page reuse —
prefix-cache hits and probe→ensemble seeding — becomes an explicit
``wasDerivedFrom`` edge between traces. Every record is a plain
hashable dict, so the lineage inherits the trace substrate's
determinism: same run, same record hashes, same chain head.

``lineage`` answers the operator question — "which member produced
this answer, via which route decision, from which probe samples?" —
by walking the relation graph backwards from a task's answer entity
(``launch/serve.py --lineage <task>`` is the CLI front end) and
re-verifying the content hash of every span the walk touched.

Identifiers (deterministic, derived from span ids):
  ``answer:{trace}``      the task's final answer entity
  ``route:{trace}``       the route decision entity
  ``probe:{trace}``       the probe sample set entity
  ``member:{trace}/{mi}`` ensemble member ``mi``'s answer entity
  ``attrib:{trace}``      the leave-one-out counterfactual entity
  ``act:{span}``          the activity for span ``{span}``
  ``model:{name}``        a model agent
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.teamllm.trace import content_hash


def _rec(kind: str, **fields: Any) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"event": "prov", "kind": kind}
    for k in sorted(fields):
        if fields[k] is not None:
            rec[k] = fields[k]
    return rec


def _entity(eid: str, **fields: Any) -> Dict[str, Any]:
    return _rec("entity", id=eid, **fields)


def _activity(span: Dict[str, Any]) -> Dict[str, Any]:
    return _rec("activity", id=f"act:{span['span']}",
                phase=span["phase"], trace=span["trace"],
                tick=span["tick"], span=span["span"],
                span_hash=content_hash(span))


def prov_records(spans: Sequence[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Derive the PROV graph from one run's span stream. Output order
    is deterministic: span order for activities, then per-trace
    entity/relation blocks in first-retire order."""
    out: List[Dict[str, Any]] = []
    agents: Dict[str, bool] = {}
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        out.append(_activity(s))
        by_trace.setdefault(s["trace"], []).append(s)
        m = s.get("model")
        if m and m not in agents:
            agents[m] = True
            out.append(_rec("agent", id=f"model:{m}", model=m))

    for trace, tspans in by_trace.items():
        probe_act = route_act = judge_act = None
        retire = attrib = None
        member_act: Dict[int, Dict[str, Any]] = {}
        member_launch: Dict[int, Dict[str, Any]] = {}
        kv_spans: List[Dict[str, Any]] = []
        for s in tspans:
            p = s["phase"]
            if p == "probe_decode":
                probe_act = s            # last probe megastep
            elif p == "route":
                route_act = s
            elif p == "member_launch":
                member_launch[int(s["member"])] = s
            elif p == "member_decode" and s.get("done"):
                mi = s.get("member")
                if mi is not None:
                    member_act[int(mi)] = s
            elif p == "judge":
                judge_act = s
            elif p == "retire":
                retire = s
            elif p == "attribution":
                attrib = s
            elif p == "kv_reuse":
                kv_spans.append(s)
        if retire is None:
            continue                     # still in flight / displaced

        probe_eid = f"probe:{trace}"
        route_eid = f"route:{trace}"
        answer_eid = f"answer:{trace}"
        if probe_act is not None:
            out.append(_entity(probe_eid, trace=trace))
            out.append(_rec("wasGeneratedBy", entity=probe_eid,
                            activity=f"act:{probe_act['span']}"))
        if route_act is not None:
            out.append(_entity(route_eid, trace=trace,
                               sigma=route_act.get("sigma"),
                               mode=route_act.get("mode")))
            out.append(_rec("wasGeneratedBy", entity=route_eid,
                            activity=f"act:{route_act['span']}"))
            if probe_act is not None:
                out.append(_rec("used",
                                activity=f"act:{route_act['span']}",
                                entity=probe_eid))
                out.append(_rec("wasDerivedFrom", entity=route_eid,
                                source=probe_eid))

        member_eids: List[str] = []
        judged = set(judge_act.get("members", [])) \
            if judge_act is not None else set(member_launch)
        for mi in sorted(member_launch):
            if mi not in judged:
                continue
            ls = member_launch[mi]
            eid = f"member:{trace}/{mi}"
            member_eids.append(eid)
            out.append(_entity(eid, trace=trace, member=mi,
                               model=ls.get("model")))
            gen = member_act.get(mi, ls)
            out.append(_rec("wasGeneratedBy", entity=eid,
                            activity=f"act:{gen['span']}"))
            out.append(_rec("used",
                            activity=f"act:{ls['span']}",
                            entity=route_eid))
            out.append(_rec("wasDerivedFrom", entity=eid,
                            source=route_eid))
            if ls.get("model"):
                out.append(_rec("wasAttributedTo", entity=eid,
                                agent=f"model:{ls['model']}"))

        out.append(_entity(answer_eid, trace=trace,
                           task_id=retire.get("task_id"),
                           answer=retire.get("final_answer")))
        gen = judge_act if judge_act is not None else retire
        out.append(_rec("wasGeneratedBy", entity=answer_eid,
                        activity=f"act:{gen['span']}"))
        sources = member_eids or ([probe_eid]
                                  if probe_act is not None else [])
        for src in sources:
            out.append(_rec("used", activity=f"act:{gen['span']}",
                            entity=src))
            out.append(_rec("wasDerivedFrom", entity=answer_eid,
                            source=src))

        # KV page reuse: pages another trace's prefill populated (or
        # this trace's probe pages) flowed into this execution
        for s in kv_spans:
            src_trace = s.get("source")
            if src_trace is None:
                continue
            src_eid = (probe_eid if src_trace == trace
                       else f"answer:{src_trace}")
            out.append(_rec("wasDerivedFrom",
                            entity=answer_eid, source=src_eid,
                            via=f"act:{s['span']}",
                            kv=s.get("kind")))

        if attrib is not None:
            aid = f"attrib:{trace}"
            out.append(_entity(aid, trace=trace,
                               values=attrib.get("values")))
            out.append(_rec("wasGeneratedBy", entity=aid,
                            activity=f"act:{attrib['span']}"))
            out.append(_rec("used",
                            activity=f"act:{attrib['span']}",
                            entity=answer_eid))
    return out


def lineage(spans: Sequence[Dict[str, Any]], task_id: str,
            records: Optional[Sequence[Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
    """Walk the PROV graph backwards from ``task_id``'s final answer:
    returns the ordered relation path (answer → judge → members →
    route → probe, plus KV-reuse derivations), every entity/activity
    on it, and a hash check re-verifying each touched span record
    against the hash its activity captured at build time.

    ``records`` accepts a previously materialized PROV graph (e.g.
    persisted at serve time); the walk then verifies the current span
    stream against the hashes *that* graph captured, catching spans
    tampered after the fact. Default (None) rebuilds the graph from
    ``spans`` — tamper detection for the default path is the span
    file's own hash chain (``verify_span_file``).

    Result keys: ``trace``, ``records`` (the walked PROV records),
    ``verified`` (spans re-hashed OK), ``hash_failures``, ``ok``.
    """
    trace = None
    span_by_id: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        span_by_id[s["span"]] = s
        if s["phase"] == "retire" and s.get("task_id") == task_id:
            trace = s["trace"]           # latest admission wins
    if trace is None:
        return {"trace": None, "records": [], "verified": 0,
                "hash_failures": [f"no retired trace for {task_id}"],
                "ok": False}

    if records is None:
        records = prov_records(spans)
    by_entity: Dict[str, List[Dict[str, Any]]] = {}
    entities: Dict[str, Dict[str, Any]] = {}
    activities: Dict[str, Dict[str, Any]] = {}
    for r in records:
        if r["kind"] == "entity":
            entities[r["id"]] = r
        elif r["kind"] == "activity":
            activities[r["id"]] = r
        elif r["kind"] in ("wasGeneratedBy", "wasDerivedFrom",
                           "wasAttributedTo"):
            by_entity.setdefault(r["entity"], []).append(r)

    walked: List[Dict[str, Any]] = []
    seen: set = set()
    acts: List[str] = []
    frontier = [f"answer:{trace}"]
    while frontier:
        eid = frontier.pop(0)
        if eid in seen:
            continue
        seen.add(eid)
        if eid in entities:
            walked.append(entities[eid])
        for r in by_entity.get(eid, ()):
            walked.append(r)
            if r["kind"] == "wasGeneratedBy":
                acts.append(r["activity"])
            elif r["kind"] == "wasDerivedFrom":
                frontier.append(r["source"])

    verified = 0
    failures: List[str] = []
    for aid in acts:
        act = activities.get(aid)
        if act is None:
            failures.append(f"missing activity {aid}")
            continue
        walked.append(act)
        s = span_by_id.get(act["span"])
        if s is None:
            failures.append(f"missing span {act['span']}")
        elif content_hash(s) != act["span_hash"]:
            failures.append(f"hash mismatch at {act['span']}")
        else:
            verified += 1
    return {"trace": trace, "records": walked, "verified": verified,
            "hash_failures": failures, "ok": not failures}


def verify_span_file(path) -> Dict[str, Any]:
    """Audit a flushed span chain (``SpanLog.flush`` output) with the
    artifact-store verifier: re-hash every record, re-link the chain.
    Returns the ``ArtifactStore.audit`` dict."""
    from repro_torch.teamllm.artifacts import ArtifactStore
    return ArtifactStore(path).audit()
