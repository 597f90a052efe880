"""The endpoint-dependency graph object and its scorers.

Parity with KMamiz src/classes/EndpointDependencies.ts: deprecated
endpoint filtering, trim/label, force-graph data with per-node highlight
closures, service-level rollups with per-distance link details, chord data,
set-union merge, and the SIUC cohesion / SDP instability / ACS coupling
scorers. The device-accelerated CSR variants of the scorers live in
kmamiz_tpu_torch.ops.scorers and are parity-checked against this implementation.
"""
from __future__ import annotations

import time as _time
from itertools import compress
from typing import Callable, Dict, List, Optional, Set

from kmamiz_tpu_torch.config import parse_threshold_ms, settings
from kmamiz_tpu_torch.core.schema import js_str as _js_str


def _now_ms() -> float:
    return _time.time() * 1000


def keeps_every_record() -> bool:
    """Whether the constructor's deprecation filter is the identity (no
    DEPRECATED_ENDPOINT_THRESHOLD set)."""
    return parse_threshold_ms(settings.deprecated_endpoint_threshold) == 0


def _dedup(entries: List[dict]) -> List[dict]:
    """trim's rule for one list: one entry per (distance, endpoint), at
    the place of its first and with the value of its last."""
    kept: Dict[str, dict] = {}
    for dep in entries:
        kept[f"{dep['distance']}\t{dep['endpoint']['uniqueEndpointName']}"] = dep
    return list(kept.values())


def _key(dep: dict) -> str:
    """combine_with's identity of an entry: its endpoint and distance."""
    return f"{dep['endpoint']['uniqueEndpointName']}\t{dep['distance']}"


class EndpointDependencies:
    # raw (caller_uen, callee_uen, distance) triples for the window, captured
    # BEFORE deprecation filtering; only set by Traces.to_endpoint_dependencies
    window_edges = None
    # set on trim()'s result: trimming is idempotent, and the realtime
    # tick trims the same records again on their way into the labeled view
    _trimmed = False
    # set where no record and no entry carries a store "_id", so that
    # to_json has nothing to strip: Traces' records, and what combine_with,
    # trim and handed_over make of such
    _clean = False
    # combine_with's output, per record: how many entries of each list
    # precede the ones it appended, and whether those are unique already.
    # The appended ones are unique and share no key with them, so trim
    # need only dedup what precedes them.
    _trim_hint: Optional[List[tuple]] = None
    # combine_with's and its trim's output, per record: the _key of each
    # entry of its two lists, for the next combine_with to merge by
    _keys: Optional[List[list]] = None

    def __init__(
        self,
        dependencies: List[dict],
        now_ms: Optional[float] = None,
    ) -> None:
        self._now_ms = now_ms if now_ms is not None else _now_ms()
        self._dependencies = self._filter_out_deprecated(dependencies)

    # -- deprecated-endpoint filtering (EndpointDependencies.ts:44-74) -------

    def _filter_out_deprecated(self, dependencies: List[dict]) -> List[dict]:
        deprecated_ms = parse_threshold_ms(settings.deprecated_endpoint_threshold)
        if deprecated_ms == 0:
            return dependencies
        deprecated_ts = self._now_ms - deprecated_ms
        deprecated_names: Set[str] = set()
        kept = []
        for dep in dependencies:
            last_used = dep.get("lastUsageTimestamp")
            # a record WITHOUT the timestamp stays: the reference's
            # `undefined < deprecatedTimestamp` is false (
            # older documents lack the field and must not be purged)
            if last_used is not None and last_used < deprecated_ts:
                deprecated_names.add(dep["endpoint"]["uniqueEndpointName"])
            else:
                kept.append(dep)
        for dep in kept:
            dep["dependingBy"] = [
                d
                for d in dep["dependingBy"]
                if d["endpoint"]["uniqueEndpointName"] not in deprecated_names
            ]
            dep["dependingOn"] = [
                d
                for d in dep["dependingOn"]
                if d["endpoint"]["uniqueEndpointName"] not in deprecated_names
            ]
        return kept

    def to_json(self) -> List[dict]:
        # The top-level dict is always a fresh copy (store insert_many
        # stamps "_id" onto the documents it is handed; aliasing it would
        # write that into this instance). The by/on ENTRY dicts are only
        # rebuilt when they actually carry a Mongo "_id" — for the tick
        # path (records fresh from Traces) nothing does, and the former
        # unconditional per-entry dict rebuilds were one of the largest
        # host costs of the DataProcessor tick. Downstream code never
        # mutates entry dicts in place (label/trim/combine_with all build
        # {**d, ...} copies), so sharing them is safe.
        if self._clean:
            return [dict(d) for d in self._dependencies]
        out = []
        for dep in self._dependencies:
            d = dict(dep)
            d.pop("_id", None)
            by = d["dependingBy"]
            if any("_id" in x for x in by):
                d["dependingBy"] = [
                    {k: v for k, v in x.items() if k != "_id"} for x in by
                ]
            on = d["dependingOn"]
            if any("_id" in x for x in on):
                d["dependingOn"] = [
                    {k: v for k, v in x.items() if k != "_id"} for x in on
                ]
            out.append(d)
        return out

    @property
    def dependencies(self) -> List[dict]:
        return self._dependencies

    # -- trim (EndpointDependencies.ts:91-112) -------------------------------

    def trim(self) -> "EndpointDependencies":
        if self._trimmed:
            return self
        hint, keys = self._trim_hint, self._keys
        trimmed, trimmed_keys = [], []
        for i, d in enumerate(self._dependencies):
            by, on = d["dependingBy"], d["dependingOn"]
            if hint is None:
                by, on = _dedup(by), _dedup(on)
            else:
                n_by, n_on, unique = hint[i]
                if unique:
                    by, on = list(by), list(on)
                    trimmed_keys.append(keys[i])
                else:
                    base_by, base_on = _dedup(by[:n_by]), _dedup(on[:n_on])
                    by, on = base_by + by[n_by:], base_on + on[n_on:]
                    trimmed_keys.append(
                        [
                            [_key(x) for x in base_by] + keys[i][0][n_by:],
                            [_key(x) for x in base_on] + keys[i][1][n_on:],
                        ]
                    )
            trimmed.append({**d, "dependingBy": by, "dependingOn": on})
        out = EndpointDependencies(trimmed, now_ms=self._now_ms)
        out._trimmed = True
        out._clean = self._clean
        if hint is not None and keeps_every_record():
            out._keys = trimmed_keys
        return out

    def handed_over(self, now_ms: Optional[float] = None) -> "EndpointDependencies":
        """What EndpointDependencies(self.to_json(), now_ms) holds: the
        reference rebuilds the records from their JSON where the DP
        protocol hands them over. With no deprecation filter those are
        these records under the new clock (stripped of store ids, if any),
        and the flags and the trim hint carry over."""
        if not keeps_every_record():
            return EndpointDependencies(self.to_json(), now_ms=now_ms)
        out = EndpointDependencies([], now_ms=now_ms)
        out._dependencies = self._dependencies if self._clean else self.to_json()
        out._trimmed = self._trimmed
        out._clean = True
        out._trim_hint = self._trim_hint if self._clean else None
        out._keys = self._keys
        return out

    # -- labeling (EndpointDependencies.ts:114-153) --------------------------

    def label(
        self, get_label: Callable[[str], Optional[str]]
    ) -> List[dict]:
        out = []
        for d in self._dependencies:
            out.append(
                {
                    "endpoint": {
                        **d["endpoint"],
                        "labelName": get_label(d["endpoint"]["uniqueEndpointName"]),
                    },
                    "isDependedByExternal": d.get("isDependedByExternal"),
                    "lastUsageTimestamp": d.get("lastUsageTimestamp"),
                    "dependingOn": [
                        {
                            **dep,
                            "endpoint": {
                                **dep["endpoint"],
                                "labelName": get_label(
                                    dep["endpoint"]["uniqueEndpointName"]
                                ),
                            },
                        }
                        for dep in d["dependingOn"]
                    ],
                    "dependingBy": [
                        {
                            **dep,
                            "endpoint": {
                                **dep["endpoint"],
                                "labelName": get_label(
                                    dep["endpoint"]["uniqueEndpointName"]
                                ),
                            },
                        }
                        for dep in d["dependingBy"]
                    ],
                }
            )
        return out

    # -- force-graph data (EndpointDependencies.ts:157-367) ------------------

    def to_graph_data(self) -> dict:
        service_endpoint_map: Dict[str, List[dict]] = {}
        for dep in self._dependencies:
            key = f"{dep['endpoint']['service']}\t{dep['endpoint']['namespace']}"
            service_endpoint_map.setdefault(key, []).append(dep)

        nodes, links = self._create_base_nodes_and_links(service_endpoint_map)
        return self._create_highlight_nodes_and_links(self._dependencies, nodes, links)

    def _create_base_nodes_and_links(
        self, service_endpoint_map: Dict[str, List[dict]]
    ):
        inactive_ms = parse_threshold_ms(settings.inactive_endpoint_threshold)
        inactive_ts = 0 if inactive_ms == 0 else self._now_ms - inactive_ms

        exist_labels: Set[str] = set()
        exist_links: Set[str] = set()
        nodes: List[dict] = [
            {
                "id": "null",
                "group": "null",
                "name": "external requests",
                "dependencies": [],
                "linkInBetween": [],
                "usageStatus": "Active",
            }
        ]
        links: List[dict] = []
        for service, endpoints in service_endpoint_map.items():
            service_last_use = max((e.get("lastUsageTimestamp") or 0) for e in endpoints)
            nodes.append(
                {
                    "id": service,
                    "group": service,
                    "name": service.replace("\t", "."),
                    "dependencies": [],
                    "linkInBetween": [],
                    "usageStatus": "Active"
                    if inactive_ts == 0 or service_last_use >= inactive_ts
                    else "Inactive",
                }
            )
            for e in endpoints:
                ep = e["endpoint"]
                node_id = (
                    f"{ep['uniqueServiceName']}\t{ep['method']}"
                    f"\t{_js_str(ep.get('labelName'))}"
                )
                if node_id not in exist_labels:
                    nodes.append(
                        {
                            "id": node_id,
                            "group": service,
                            "name": (
                                f"({ep['version']}) {ep['method']} "
                                f"{_js_str(ep.get('labelName'))}"
                            ),
                            "dependencies": [],
                            "linkInBetween": [],
                            "usageStatus": "Active"
                            if inactive_ts == 0
                            or (e.get("lastUsageTimestamp") or 0) >= inactive_ts
                            else "Inactive",
                        }
                    )
                    exist_labels.add(node_id)
                if f"{service}\t{node_id}" not in exist_links:
                    links.append({"source": service, "target": node_id})
                    exist_links.add(f"{service}\t{node_id}")
                for dep in e["dependingOn"]:
                    if dep["distance"] != 1:
                        continue
                    dep_ep = dep["endpoint"]
                    dep_id = (
                        f"{dep_ep['uniqueServiceName']}\t{dep_ep['method']}"
                        f"\t{_js_str(dep_ep.get('labelName'))}"
                    )
                    if f"{node_id}\t{dep_id}" not in exist_links:
                        links.append({"source": node_id, "target": dep_id})
                        exist_links.add(f"{node_id}\t{dep_id}")
                if e.get("isDependedByExternal"):
                    if f"null\t{node_id}" not in exist_links:
                        links.append({"source": "null", "target": node_id})
                        exist_links.add(f"null\t{node_id}")
        return nodes, links

    def _create_highlight_nodes_and_links(
        self, dependencies: List[dict], nodes: List[dict], links: List[dict]
    ) -> dict:
        with_id = [
            {
                **dep,
                "uid": (
                    f"{dep['endpoint']['uniqueServiceName']}"
                    f"\t{dep['endpoint']['method']}"
                    f"\t{_js_str(dep['endpoint'].get('labelName'))}"
                ),
                "sid": f"{dep['endpoint']['service']}\t{dep['endpoint']['namespace']}",
            }
            for dep in dependencies
        ]

        # indexes replacing the reference's per-node linear scans (the O(V*E)
        # closure SURVEY.md flags); iteration order inside each bucket is
        # with_id/links order, so emitted output is byte-identical
        by_uid: Dict[str, List[dict]] = {}
        by_sid: Dict[str, List[str]] = {}
        zero_by_uids: List[str] = []
        for d in with_id:
            by_uid.setdefault(d["uid"], []).append(d)
            by_sid.setdefault(d["sid"], []).append(d["uid"])
            if len(d["dependingBy"]) == 0:
                zero_by_uids.append(d["uid"])
        links_by_source: Dict[str, List[dict]] = {}
        links_by_target: Dict[str, List[dict]] = {}
        for l in links:
            links_by_source.setdefault(l["source"], []).append(l)
            links_by_target.setdefault(l["target"], []).append(l)
        link_index = (links_by_source, links_by_target)

        for n in nodes:
            if n["id"] == "null":
                n["dependencies"] = list(zero_by_uids)
                n["linkInBetween"] = [
                    {"source": "null", "target": d} for d in n["dependencies"]
                ]
            elif n["id"] == n["group"]:
                n["dependencies"] = list(by_sid.get(n["id"], []))
                n["linkInBetween"] = [
                    {"source": n["id"], "target": d} for d in n["dependencies"]
                ]
            else:
                matching = by_uid.get(n["id"], [])
                n["linkInBetween"] = []
                n["dependencies"] = []
                for node in matching:
                    d_on = sorted(
                        node["dependingOn"], key=lambda d: -d["distance"]
                    )
                    d_by = sorted(
                        node["dependingBy"], key=lambda d: -d["distance"]
                    )
                    n["linkInBetween"] = (
                        n["linkInBetween"]
                        + self._map_to_links(d_on, n, link_index)
                        + self._map_to_links(d_by, n, link_index)
                    )
                    seen: Set[str] = set()
                    merged_ids = []
                    for i in self._remap_to_id(d_on) + self._remap_to_id(d_by):
                        if i not in seen:
                            seen.add(i)
                            merged_ids.append(i)
                    n["dependencies"] = n["dependencies"] + merged_ids
                # dedupe links preserving order
                seen_links: Set[str] = set()
                deduped = []
                for l in n["linkInBetween"]:
                    key = f"{l['source']}\t\t{l['target']}"
                    if key not in seen_links:
                        seen_links.add(key)
                        deduped.append({"source": l["source"], "target": l["target"]})
                n["linkInBetween"] = deduped
        return {"nodes": nodes, "links": links}

    @staticmethod
    def _remap_to_id(deps: List[dict]) -> List[str]:
        return [
            (
                f"{d['endpoint']['uniqueServiceName']}\t{d['endpoint']['method']}"
                f"\t{_js_str(d['endpoint'].get('labelName'))}"
            )
            for d in deps
        ]

    def _map_to_links(
        self, deps: List[dict], node: dict, link_index: tuple
    ) -> List[dict]:
        links_by_source, links_by_target = link_index
        out = []
        ids = self._remap_to_id(deps)
        for i, d in enumerate(deps):
            dep_id = ids[i]
            remaining = set(ids[i + 1 :]) | {node["id"]}
            if d["type"] == "SERVER":
                candidates, dst = links_by_target.get(dep_id, ()), "source"
            else:
                candidates, dst = links_by_source.get(dep_id, ()), "target"
            out.extend(l for l in candidates if l[dst] in remaining)
        return out

    # -- service-level rollup (EndpointDependencies.ts:369-470) --------------

    def to_service_dependencies(self) -> List[dict]:
        service_names: List[str] = []
        seen: Set[str] = set()
        for dep in self._dependencies:
            name = dep["endpoint"]["uniqueServiceName"]
            if name not in seen:
                seen.add(name)
                service_names.append(name)

        out = []
        for unique_service_name in service_names:
            dependency = [
                d
                for d in self._dependencies
                if d["endpoint"]["uniqueServiceName"] == unique_service_name
            ]
            link_map = self._service_to_links_mapping(dependency)
            service, namespace, version = unique_service_name.split("\t")
            out.append(
                {
                    "service": service,
                    "namespace": namespace,
                    "version": version,
                    "dependency": dependency,
                    "links": [
                        {
                            "service": n.split("\t")[0],
                            "namespace": n.split("\t")[1],
                            "version": n.split("\t")[2],
                            **info,
                            "uniqueServiceName": n,
                        }
                        for n, info in link_map.items()
                    ],
                    "uniqueServiceName": unique_service_name,
                }
            )
        return out

    @staticmethod
    def _service_to_links_mapping(dependency: List[dict]) -> Dict[str, dict]:
        distance_link_set: List[str] = []
        seen: Set[str] = set()
        for dep in dependency:
            for d in dep["dependingOn"] + dep["dependingBy"]:
                ep = d["endpoint"]
                key = (
                    f"{ep['uniqueServiceName']}\t{ep['method']}"
                    f"\t{_js_str(ep.get('labelName'))}\t{d['type']}\t{d['distance']}"
                )
                if key not in seen:
                    seen.add(key)
                    distance_link_set.append(key)

        detail_map: Dict[str, Dict[int, dict]] = {}
        for key in distance_link_set:
            tokens = key.split("\t")
            service, namespace, version = tokens[0], tokens[1], tokens[2]
            link_type, distance = tokens[5], int(tokens[6])
            unique_service_name = f"{service}\t{namespace}\t{version}"
            existing = detail_map.setdefault(unique_service_name, {})
            detail = existing.get(
                distance,
                {"count": 0, "dependingBy": 0, "dependingOn": 0, "distance": distance},
            )
            existing[distance] = {
                "count": detail["count"] + 1,
                "dependingBy": detail["dependingBy"] + (1 if link_type == "CLIENT" else 0),
                "dependingOn": detail["dependingOn"] + (1 if link_type == "SERVER" else 0),
                "distance": distance,
            }

        link_map: Dict[str, dict] = {}
        for unique_service_name, details_by_distance in detail_map.items():
            details = list(details_by_distance.values())
            link_map[unique_service_name] = {
                "details": details,
                "count": sum(d["count"] for d in details),
                "dependingBy": sum(d["dependingBy"] for d in details),
                "dependingOn": sum(d["dependingOn"] for d in details),
            }
        return link_map

    # -- chord data (EndpointDependencies.ts:472-497) ------------------------

    def to_chord_data(self) -> dict:
        def name_to_id(unique_service_name: str) -> str:
            service, namespace, version = unique_service_name.split("\t")
            return f"{service}.{namespace} ({version})"

        svc_dep = self.to_service_dependencies()
        links = [
            {
                "from": s["uniqueServiceName"],
                "to": l["uniqueServiceName"],
                "value": l["dependingOn"],
            }
            for s in svc_dep
            for l in s["links"]
            if l["dependingOn"] > 0
        ]
        node_names: List[str] = []
        seen: Set[str] = set()
        for l in links:
            for n in (l["from"], l["to"]):
                if n not in seen:
                    seen.add(n)
                    node_names.append(n)
        return {
            "nodes": [{"id": name_to_id(n), "name": n} for n in node_names],
            "links": [
                {**l, "from": name_to_id(l["from"]), "to": name_to_id(l["to"])}
                for l in links
            ],
        }

    # -- set-union merge (EndpointDependencies.ts:499-563) -------------------

    def combine_with(self, other: "EndpointDependencies") -> "EndpointDependencies":
        # name -> [record, its [by keys, on keys], their sets or None,
        # whether the record is this call's copy, the trim hint]. A record's
        # key sets are built when an entry is first merged into it, and
        # other's records and key lists are copied only then; other's key
        # lists are the ones the instance that made it kept, if it did.
        dependency_map: Dict[str, list] = {}
        for d in self._dependencies:
            by, on = list(d["dependingBy"]), list(d["dependingOn"])
            dependency_map[d["endpoint"]["uniqueEndpointName"]] = [
                {**d, "dependingBy": by, "dependingOn": on},
                [[_key(x) for x in by], [_key(x) for x in on]],
                None,
                True,
                (len(by), len(on), False),
            ]
        other_keys = other._keys
        for i, d in enumerate(other._dependencies):
            incoming = (d["dependingBy"], d["dependingOn"])
            incoming_keys = (
                other_keys[i]
                if other_keys is not None
                else [[_key(x) for x in incoming[0]], [_key(x) for x in incoming[1]]]
            )
            name = d["endpoint"]["uniqueEndpointName"]
            entry = dependency_map.get(name)
            if entry is None:
                hint = (len(incoming[0]), len(incoming[1]), other._trimmed)
                dependency_map[name] = [d, incoming_keys, None, False, hint]
                continue
            # The reference assigns the max timestamp to the incoming
            # entry `d` and then discards it (EndpointDependencies.ts:517),
            # so the kept entry retains its original lastUsageTimestamp;
            # mirrored here for parity.
            if not entry[3]:
                kept = entry[0]
                entry[0] = {**kept, "dependingBy": list(kept["dependingBy"]), "dependingOn": list(kept["dependingOn"])}
                entry[1] = [list(entry[1][0]), list(entry[1][1])]
                entry[3] = True
            if entry[2] is None:
                entry[2] = (set(entry[1][0]), set(entry[1][1]))
            record = entry[0]
            for side, keys, seen, deps, dep_keys in zip(
                ("dependingBy", "dependingOn"), entry[1], entry[2], incoming, incoming_keys
            ):
                merged = record[side]
                if other._trimmed:
                    # d's keys are unique: append those the record lacks
                    fresh = [key not in seen for key in dep_keys]
                    merged.extend(compress(deps, fresh))
                    keys.extend(compress(dep_keys, fresh))
                    continue
                for dep, key in zip(deps, dep_keys):
                    if key not in seen:
                        merged.append(dep)
                        keys.append(key)
                        seen.add(key)
            if other._trimmed:
                entry[2] = None  # rebuilt from the keys if d's name comes again
        out = EndpointDependencies(
            [entry[0] for entry in dependency_map.values()],
            now_ms=self._now_ms,
        )
        out._clean = self._clean and other._clean
        if keeps_every_record():  # else the constructor may drop records
            out._trim_hint = [entry[4] for entry in dependency_map.values()]
            out._keys = [entry[1] for entry in dependency_map.values()]
        return out

    # -- scorers -------------------------------------------------------------

    def to_service_endpoint_cohesion(self) -> List[dict]:
        """SIUC: service intra-usage cohesion (EndpointDependencies.ts:565-612)."""
        service_endpoint_map: Dict[str, List[dict]] = {}
        for d in self._dependencies:
            service_endpoint_map.setdefault(
                d["endpoint"]["uniqueServiceName"], []
            ).append(d)

        out = []
        for unique_service_name, endpoints in service_endpoint_map.items():
            utilized: Dict[str, Set[str]] = {}
            for e in endpoints:
                for dep in e["dependingBy"]:
                    if dep["distance"] != 1:
                        continue
                    consumer = dep["endpoint"]["uniqueServiceName"]
                    utilized.setdefault(consumer, set()).add(
                        e["endpoint"]["uniqueEndpointName"]
                    )
            consumers = [
                {"uniqueServiceName": name, "consumes": len(consumed)}
                for name, consumed in utilized.items()
            ]
            cohesion = 0.0
            if endpoints and consumers:
                cohesion = sum(
                    c["consumes"] / len(endpoints) for c in consumers
                ) / len(consumers)
            out.append(
                {
                    "uniqueServiceName": unique_service_name,
                    "totalEndpoints": len(endpoints),
                    "consumers": consumers,
                    "endpointUsageCohesion": cohesion,
                }
            )
        return out

    def to_service_instability(self) -> List[dict]:
        """SDP instability I = Ce / (Ce + Ca) (EndpointDependencies.ts:614-641)."""
        out = []
        for s in self.to_service_dependencies():
            depending_by = sum(1 for l in s["links"] if l["dependingBy"] > 0)
            depending_on = sum(1 for l in s["links"] if l["dependingOn"] > 0)
            total = depending_on + depending_by
            out.append(
                {
                    "uniqueServiceName": s["uniqueServiceName"],
                    "name": f"{s['service']}.{s['namespace']} ({s['version']})",
                    "dependingBy": depending_by,
                    "dependingOn": depending_on,
                    "instability": 0 if total == 0 else depending_on / total,
                }
            )
        return out

    def to_service_coupling(self) -> List[dict]:
        """ACS coupling = AIS x ADS (EndpointDependencies.ts:643-657)."""
        from kmamiz_tpu_torch.analytics.risk import absolute_criticality_of_services

        coupling = absolute_criticality_of_services(self.to_service_dependencies())
        out = []
        for c in coupling:
            service, namespace, version = c["uniqueServiceName"].split("\t")
            out.append(
                {
                    "uniqueServiceName": c["uniqueServiceName"],
                    "name": f"{service}.{namespace} ({version})",
                    "ais": c["ais"],
                    "ads": c["ads"],
                    "acs": c["factor"],
                }
            )
        return out
