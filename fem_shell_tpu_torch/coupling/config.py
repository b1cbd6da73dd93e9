"""Coupling configuration — parser for the preCICE-style XML used by the
reference (preCICE/precice_config.xml:1-83): solver-interface dimensions,
vector data, meshes, participants with read/write data + nearest-neighbor
mappings, m2n sockets, and a serial-implicit coupling scheme with
relative convergence measures, IQN-ILS post-processing and extrapolation.

A copy of ``fem_shell_tpu/coupling/config.py``: the same file parses to
the same dataclasses.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class MappingCfg:
    direction: str  # 'read' | 'write'
    src: str
    dst: str
    constraint: str = "consistent"


@dataclasses.dataclass
class ParticipantCfg:
    name: str
    provided_meshes: List[str]
    received_meshes: List[str]  # (mesh, from) pairs flattened to names
    write_data: List[Tuple[str, str]]  # (data, mesh)
    read_data: List[Tuple[str, str]]
    mappings: List[MappingCfg]


@dataclasses.dataclass
class IQNILSCfg:
    data: str = "Displacements"
    mesh: str = "Structure_Nodes"
    initial_relaxation: float = 0.001
    max_used_iterations: int = 20
    timesteps_reused: int = 5
    filter: str = "QR1"
    singularity_limit: float = 1e-9


@dataclasses.dataclass
class ConvergenceCfg:
    data: str
    mesh: str
    limit: float
    kind: str = "relative"


@dataclasses.dataclass
class ExchangeCfg:
    data: str
    mesh: str
    frm: str
    to: str
    initialize: bool = False


@dataclasses.dataclass
class SchemeCfg:
    kind: str  # 'serial-implicit' | 'serial-explicit'
    first: str
    second: str
    max_time: float
    dt: float
    max_iterations: int
    exchanges: List[ExchangeCfg]
    convergence: List[ConvergenceCfg]
    acceleration: Optional[IQNILSCfg]
    extrapolation_order: int = 0


@dataclasses.dataclass
class CouplingConfig:
    dimensions: int
    data: List[str]
    meshes: Dict[str, List[str]]  # mesh -> used data names
    participants: Dict[str, ParticipantCfg]
    m2n: Tuple[str, str]  # (from, to)
    m2n_kind: str
    scheme: SchemeCfg
    port: int = 50077
    host: str = "127.0.0.1"


def _local(tag: str) -> Tuple[str, str]:
    """Split 'ns:name' style preCICE tags (rewritten to 'ns--name')."""
    for sep in ("--", ":"):
        if sep in tag:
            a, b = tag.split(sep, 1)
            return a, b
    return tag, ""


def parse_config(path: str) -> CouplingConfig:
    """Parse a preCICE-style XML config. preCICE uses colon-prefixed tags
    without XML namespace declarations (its own parser allows this);
    ElementTree rejects unbound prefixes, so tag prefixes are rewritten
    to 'prefix--name' before parsing."""
    import re

    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"<(/?)([\w-]+):([\w-]+)", r"<\1\2--\3", text)
    root = ET.fromstring(text)
    si = root.find("solver-interface")
    if si is None:
        si = root  # tolerate configs without the wrapper
    dims = int(si.get("dimensions", "3"))

    data: List[str] = []
    meshes: Dict[str, List[str]] = {}
    participants: Dict[str, ParticipantCfg] = {}
    m2n = ("", "")
    m2n_kind = "sockets"
    port = 50077
    host = "127.0.0.1"
    scheme: Optional[SchemeCfg] = None

    for el in si:
        base, sub = _local(el.tag)
        if base == "data":
            data.append(el.get("name"))
        elif base == "mesh":
            meshes[el.get("name")] = [u.get("name") for u in el.findall("use-data")]
        elif base == "m2n":
            m2n = (el.get("from"), el.get("to"))
            m2n_kind = sub or "sockets"
            port = int(el.get("port", port))
            host = el.get("network", None) and host or el.get("host", host)
        elif base == "participant":
            name = el.get("name")
            provided, received = [], []
            wr, rd, maps = [], [], []
            for c in el:
                cb, cs = _local(c.tag)
                if cb == "use-mesh":
                    if c.get("provide", "no") == "yes":
                        provided.append(c.get("name"))
                    else:
                        received.append(c.get("name"))
                elif cb == "write-data":
                    wr.append((c.get("name"), c.get("mesh")))
                elif cb == "read-data":
                    rd.append((c.get("name"), c.get("mesh")))
                elif cb == "mapping":
                    maps.append(
                        MappingCfg(
                            direction=c.get("direction"),
                            src=c.get("from"),
                            dst=c.get("to"),
                            constraint=c.get("constraint", "consistent"),
                        )
                    )
            participants[name] = ParticipantCfg(name, provided, received, wr, rd, maps)
        elif base == "coupling-scheme":
            parts = el.find("participants")
            exchanges = [
                ExchangeCfg(
                    data=x.get("data"),
                    mesh=x.get("mesh"),
                    frm=x.get("from"),
                    to=x.get("to"),
                    initialize=x.get("initialize", "false") in ("true", "1", "yes"),
                )
                for x in el.findall("exchange")
            ]
            conv = [
                ConvergenceCfg(
                    data=c.get("data"), mesh=c.get("mesh"), limit=float(c.get("limit"))
                )
                for c in el.findall("relative-convergence-measure")
            ]
            accel = None
            for pp in el:
                pb, ps = _local(pp.tag)
                if pb == "post-processing" or pb == "acceleration":
                    d = pp.find("data")
                    accel = IQNILSCfg(
                        data=d.get("name") if d is not None else "Displacements",
                        mesh=d.get("mesh") if d is not None else "Structure_Nodes",
                    )
                    def _val(tag, default):
                        e = pp.find(tag)
                        if e is None and d is not None:
                            e = d.find(tag)
                        return e.get("value") if e is not None and e.get("value") else default
                    accel.initial_relaxation = float(_val("initial-relaxation", 0.001))
                    accel.max_used_iterations = int(_val("max-used-iterations", 20))
                    accel.timesteps_reused = int(_val("timesteps-reused", 5))
                    sl = pp.find("singularity-limit")
                    if sl is None and d is not None:
                        sl = d.find("singularity-limit")
                    accel.singularity_limit = float(sl.get("value")) if sl is not None else 1e-9
            mt = el.find("max-time")
            ts = el.find("timestep-length")
            mi = el.find("max-iterations")
            eo = el.find("extrapolation-order")
            scheme = SchemeCfg(
                kind=sub,
                first=parts.get("first"),
                second=parts.get("second"),
                max_time=float(mt.get("value")) if mt is not None else 1.0,
                dt=float(ts.get("value")) if ts is not None else 0.01,
                max_iterations=int(mi.get("value")) if mi is not None else 100,
                exchanges=exchanges,
                convergence=conv,
                acceleration=accel,
                extrapolation_order=int(eo.get("value")) if eo is not None else 0,
            )
    if scheme is None:
        raise ValueError(f"{path}: no coupling-scheme found")
    return CouplingConfig(
        dimensions=dims,
        data=data,
        meshes=meshes,
        participants=participants,
        m2n=m2n,
        m2n_kind=m2n_kind,
        scheme=scheme,
        port=port,
        host=host,
    )
