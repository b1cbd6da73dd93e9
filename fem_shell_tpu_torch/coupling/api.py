"""Participant API + serial-implicit coupling scheme.

A self-contained reimplementation of the preCICE ``SolverInterface``
surface the reference uses (fem-shell_precice.cpp:51-170, 257-410;
fluid_solver.cpp:59-238): mesh registration, initial-data handshake,
blocking ``advance`` with data exchange over an m2n transport, implicit
iteration control with relative convergence measures, IQN-ILS
acceleration on the second participant, and the three checkpoint/initial
action flags.

Scheme semantics (serial-implicit, first=FLUID, second=STRUCTURE, as in
precice_config.xml:57-78): per coupling iteration the first participant
sends its written exchanges and blocks; the second receives them, sends
back its (possibly accelerated) written exchanges plus the
converged/ongoing status. The second participant owns the convergence
measure, the acceleration, and the simulation clock.

A copy of ``fem_shell_tpu/coupling/api.py``; host numpy only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from fem_shell_tpu_torch.coupling.accel import IQNILS
from fem_shell_tpu_torch.coupling.config import CouplingConfig, parse_config
from fem_shell_tpu_torch.coupling.m2n import SocketTransport, Transport
from fem_shell_tpu_torch.coupling.mapping import NearestNeighborMapping

# action constants (precice::constants analog)
ACTION_WRITE_INITIAL_DATA = "write-initial-data"
ACTION_WRITE_ITERATION_CHECKPOINT = "write-iteration-checkpoint"
ACTION_READ_ITERATION_CHECKPOINT = "read-iteration-checkpoint"


def action_write_initial_data() -> str:
    return ACTION_WRITE_INITIAL_DATA


def action_write_iteration_checkpoint() -> str:
    return ACTION_WRITE_ITERATION_CHECKPOINT


def action_read_iteration_checkpoint() -> str:
    return ACTION_READ_ITERATION_CHECKPOINT


def _extrapolate(hist, order: int) -> np.ndarray:
    """Time-extrapolated initial guess from the converged-state history
    (newest first). Falls back to the highest order the history allows —
    the same degradation preCICE applies on the first windows."""
    if order >= 2 and len(hist) >= 3:
        return 2.5 * hist[0] - 2.0 * hist[1] + 0.5 * hist[2]
    if order >= 1 and len(hist) >= 2:
        return 2.0 * hist[0] - hist[1]
    return hist[0].copy()


class Participant:
    """One coupling participant (the ``SolverInterface`` analog)."""

    def __init__(
        self,
        name: str,
        config: "str | CouplingConfig",
        rank: int = 0,
        size: int = 1,
        transport: Optional[Transport] = None,
    ):
        self.name = name
        self.cfg = parse_config(config) if isinstance(config, str) else config
        if name not in self.cfg.participants:
            raise ValueError(f"participant '{name}' not in configuration")
        self.me = self.cfg.participants[name]
        self.rank, self.size = rank, size
        self.scheme = self.cfg.scheme
        self.is_second = self.scheme.second == name
        self._transport = transport

        self._mesh_ids: Dict[str, int] = {}
        self._mesh_names: Dict[int, str] = {}
        for i, m in enumerate(sorted(self.cfg.meshes)):
            self._mesh_ids[m] = i
            self._mesh_names[i] = m
        self._data_ids: Dict[Tuple[str, int], int] = {}
        self._data_names: Dict[int, Tuple[str, str]] = {}
        nid = 0
        for m in sorted(self.cfg.meshes):
            for d in self.cfg.meshes[m]:
                self._data_ids[(d, self._mesh_ids[m])] = nid
                self._data_names[nid] = (d, m)
                nid += 1

        self._positions: Dict[str, np.ndarray] = {}  # provided + received meshes
        self._buffers: Dict[Tuple[str, str], np.ndarray] = {}  # (data, mesh) -> [n,d]
        self._maps: Dict[Tuple[str, str], NearestNeighborMapping] = {}
        self._actions = set()
        self._ongoing = True
        self._converged_last = False
        self._read_data_available = False
        self._time = 0.0
        self._iteration = 0
        self._timestep = 0
        self._initialized = False
        self._accel = None
        self._conv_prev: Dict[Tuple[str, str], np.ndarray] = {}
        # converged-state history per exchange, newest first (for time
        # extrapolation at window completion — precice_config.xml:77)
        self._extrap_hist: Dict[Tuple[str, str], list] = {}
        self._conv_seed: Dict[Tuple[str, str], np.ndarray] = {}

    # ------------------------------------------------------------------
    # identity / metadata
    def get_dimensions(self) -> int:
        return self.cfg.dimensions

    def get_mesh_id(self, mesh_name: str) -> int:
        return self._mesh_ids[mesh_name]

    def get_data_id(self, data_name: str, mesh_id: int) -> int:
        return self._data_ids[(data_name, mesh_id)]

    def set_mesh_vertices(self, mesh_id: int, positions) -> np.ndarray:
        positions = np.asarray(positions, np.float64).reshape(-1, self.cfg.dimensions)
        mesh = self._mesh_names[mesh_id]
        self._positions[mesh] = positions
        for d in self.cfg.meshes[mesh]:
            self._buffers[(d, mesh)] = np.zeros_like(positions)
        return np.arange(len(positions), dtype=np.int32)

    # ------------------------------------------------------------------
    def _peer_name(self) -> str:
        return self.scheme.first if self.is_second else self.scheme.second

    def _make_transport(self) -> Transport:
        host, port = self.cfg.host, self.cfg.port
        if self.is_second:
            return SocketTransport.listen(host, port)
        return SocketTransport.connect(host, port)

    def initialize(self) -> float:
        if self._transport is None:
            self._transport = self._make_transport()
        # mesh handshake: send my provided meshes, receive peer's
        mine = {m: self._positions[m] for m in self.me.provided_meshes if m in self._positions}
        self._transport.send({"tag": "meshes", "meshes": mine})
        msg = self._transport.recv()
        assert msg["tag"] == "meshes"
        for m, pos in msg["meshes"].items():
            self._positions.setdefault(m, pos)
            for d in self.cfg.meshes.get(m, []):
                self._buffers.setdefault((d, m), np.zeros_like(pos))
        # build my mappings
        for mc in self.me.mappings:
            self._maps[(mc.src, mc.dst)] = NearestNeighborMapping(
                self._positions[mc.src], self._positions[mc.dst]
            )
        # acceleration lives on the second participant
        if self.is_second and self.scheme.kind.endswith("implicit"):
            a = self.scheme.acceleration
            if a is not None:
                self._accel = IQNILS(
                    a.initial_relaxation,
                    a.max_used_iterations,
                    a.timesteps_reused,
                    a.singularity_limit,
                )
        # initial-data action
        for ex in self.scheme.exchanges:
            if ex.initialize and ex.frm == self.name:
                self._actions.add(ACTION_WRITE_INITIAL_DATA)
        if self.scheme.kind.endswith("implicit"):
            self._actions.add(ACTION_WRITE_ITERATION_CHECKPOINT)
        self._initialized = True
        return self.scheme.dt

    def initialize_data(self) -> None:
        send_ex = [ex for ex in self.scheme.exchanges if ex.initialize and ex.frm == self.name]
        recv_ex = [ex for ex in self.scheme.exchanges if ex.initialize and ex.to == self.name]
        if send_ex:
            payload = {}
            for ex in send_ex:
                payload[(ex.data, ex.mesh)] = self._outgoing_values(ex)
            self._transport.send({"tag": "init-data", "data": payload})
        if recv_ex:
            msg = self._transport.recv()
            assert msg["tag"] == "init-data"
            for key, val in msg["data"].items():
                self._store_incoming(key[0], key[1], val)
            self._read_data_available = True

    # ------------------------------------------------------------------
    # data access
    def write_block_vector_data(self, data_id: int, vertex_ids, values) -> None:
        d, m = self._data_names[data_id]
        values = np.asarray(values, np.float64).reshape(-1, self.cfg.dimensions)
        buf = self._buffers[(d, m)]
        buf[np.asarray(vertex_ids, np.int64)] = values

    def read_block_vector_data(self, data_id: int, vertex_ids) -> np.ndarray:
        d, m = self._data_names[data_id]
        return self._buffers[(d, m)][np.asarray(vertex_ids, np.int64)].copy()

    # flattened convenience variants (reference C API passes flat arrays)
    def write_block_vector_data_flat(self, data_id, vertex_ids, flat) -> None:
        self.write_block_vector_data(data_id, vertex_ids, np.asarray(flat).reshape(-1, self.cfg.dimensions))

    def read_block_vector_data_flat(self, data_id, vertex_ids) -> np.ndarray:
        return self.read_block_vector_data(data_id, vertex_ids).reshape(-1)

    # ------------------------------------------------------------------
    def _outgoing_values(self, ex) -> np.ndarray:
        """Values for an exchange I send: written data, write-mapped onto
        the exchange mesh when the write buffer lives on another mesh."""
        # direct buffer on the exchange mesh?
        for (wd, wm) in self.me.write_data:
            if wd == ex.data and wm == ex.mesh:
                return self._buffers[(wd, wm)].copy()
        # else: mapped from my write mesh
        for (wd, wm) in self.me.write_data:
            if wd == ex.data:
                mapping = self._maps.get((wm, ex.mesh))
                if mapping is None:
                    mapping = NearestNeighborMapping(self._positions[wm], self._positions[ex.mesh])
                    self._maps[(wm, ex.mesh)] = mapping
                return mapping.apply(self._buffers[(wd, wm)])
        raise KeyError(f"{self.name} does not write data '{ex.data}'")

    def _store_incoming(self, data: str, mesh: str, values: np.ndarray) -> None:
        """Store received exchange values, read-mapping onto my read mesh."""
        values = np.asarray(values, np.float64)
        self._buffers[(data, mesh)] = values.copy()
        for (rd, rm) in self.me.read_data:
            if rd == data and rm != mesh:
                mapping = self._maps.get((mesh, rm))
                if mapping is None:
                    mapping = NearestNeighborMapping(self._positions[mesh], self._positions[rm])
                    self._maps[(mesh, rm)] = mapping
                self._buffers[(rd, rm)] = mapping.apply(values)

    # ------------------------------------------------------------------
    def advance(self, dt: float) -> float:
        assert self._initialized, "advance() before initialize()"
        implicit = self.scheme.kind.endswith("implicit")
        if self.is_second:
            self._advance_second(implicit)
        else:
            self._advance_first(implicit)
        return self.scheme.dt

    def _advance_first(self, implicit: bool) -> None:
        payload = {}
        for ex in self.scheme.exchanges:
            if ex.frm == self.name:
                payload[(ex.data, ex.mesh)] = self._outgoing_values(ex)
        self._transport.send({"tag": "adv", "data": payload, "it": self._iteration})
        msg = self._transport.recv()
        assert msg["tag"] == "adv"
        for key, val in msg["data"].items():
            self._store_incoming(key[0], key[1], val)
        self._read_data_available = True
        self._apply_status(msg["converged"], msg["ongoing"], implicit)

    def _advance_second(self, implicit: bool) -> None:
        msg = self._transport.recv()
        assert msg["tag"] == "adv"
        incoming = msg["data"]
        # convergence is measured on my written exchange data (pre-acceleration)
        converged = True
        if implicit:
            for cm in self.scheme.convergence:
                cur = None
                for ex in self.scheme.exchanges:
                    if ex.data == cm.data and ex.frm == self.name:
                        cur = self._outgoing_values(ex)
                if cur is None:
                    continue
                prev = self._conv_prev.get((cm.data, cm.mesh))
                if prev is None:
                    converged = False
                else:
                    num = np.linalg.norm(cur - prev)
                    den = np.linalg.norm(cur)
                    converged = converged and (num <= cm.limit * max(den, 1e-300))
                self._conv_prev[(cm.data, cm.mesh)] = cur.copy()
            if self._iteration + 1 >= self.scheme.max_iterations:
                converged = True
        payload = {}
        for ex in self.scheme.exchanges:
            if ex.frm == self.name:
                vals = self._outgoing_values(ex)
                if (
                    implicit
                    and not converged
                    and self._accel is not None
                    and self.scheme.acceleration
                    and ex.data == self.scheme.acceleration.data
                ):
                    vals = self._accel.accelerate(vals.reshape(-1)).reshape(vals.shape)
                if implicit and converged and self.scheme.extrapolation_order > 0:
                    # window completed: record the CONVERGED state (sent
                    # unchanged — the peer extrapolates its own copy
                    # locally, like preCICE's per-scheme extrapolateData;
                    # sending predictions would pollute the peer's
                    # history with predictions of predictions) and seed
                    # the next window's convergence baseline with the
                    # prediction so a smooth first iterate can converge
                    # immediately (precice_config.xml:77 requests order 2)
                    key = (ex.data, ex.mesh)
                    hist = self._extrap_hist.setdefault(key, [])
                    hist.insert(0, vals.copy())
                    del hist[3:]
                    pred = _extrapolate(hist, self.scheme.extrapolation_order)
                    for cm in self.scheme.convergence:
                        if cm.data == ex.data:
                            self._conv_seed[(cm.data, cm.mesh)] = pred
                payload[(ex.data, ex.mesh)] = vals
        ongoing_after = self._time + self.scheme.dt < self.scheme.max_time - 1e-12
        will_advance = converged or not implicit
        self._transport.send(
            {
                "tag": "adv",
                "data": payload,
                "converged": converged,
                "ongoing": (not will_advance) or ongoing_after,
            }
        )
        # now ingest the first participant's data (forces drive the NEXT solve
        # — the reference's read-at-end-of-iteration lag, fem-shell_precice.cpp:271-323)
        for key, val in incoming.items():
            self._store_incoming(key[0], key[1], val)
        self._read_data_available = True
        self._apply_status(converged, (not will_advance) or ongoing_after, implicit)

    def _apply_status(self, converged: bool, ongoing: bool, implicit: bool) -> None:
        self._converged_last = converged
        if converged or not implicit:
            self._time += self.scheme.dt
            self._timestep += 1
            self._iteration = 0
            self._conv_prev.clear()
            if implicit and self.scheme.extrapolation_order > 0:
                # new window's convergence baseline = the extrapolated
                # prediction (computed when the window completed)
                self._conv_prev.update(self._conv_seed)
                self._conv_seed = {}
                # extrapolate my READ buffers too: the first solve of the
                # new window otherwise runs on the last window's stale
                # peer data (the forces-lag-one-iteration quirk,
                # fem-shell_precice.cpp:271-323) and its result is thrown
                # away — a 2nd-order predictor of the peer data makes
                # that first solve land on the converged state directly
                self._extrapolate_read_buffers()
            if self._accel is not None:
                self._accel.next_timestep()
            self._ongoing = ongoing
            if implicit:
                self._actions.add(ACTION_WRITE_ITERATION_CHECKPOINT)
        else:
            self._iteration += 1
            self._actions.add(ACTION_READ_ITERATION_CHECKPOINT)

    def _extrapolate_read_buffers(self) -> None:
        order = self.scheme.extrapolation_order
        for ex in self.scheme.exchanges:
            if ex.to != self.name:
                continue
            key = (ex.data, ex.mesh)
            cur = self._buffers.get(key)
            if cur is None:
                continue
            hist = self._extrap_hist.setdefault(key, [])
            hist.insert(0, cur.copy())
            del hist[3:]
            self._store_incoming(ex.data, ex.mesh, _extrapolate(hist, order))

    # ------------------------------------------------------------------
    # status / actions
    def is_coupling_ongoing(self) -> bool:
        return self._ongoing

    def is_read_data_available(self) -> bool:
        return self._read_data_available

    def is_action_required(self, action: str) -> bool:
        return action in self._actions

    def fulfilled_action(self, action: str) -> None:
        self._actions.discard(action)

    # preCICE v2-style alias
    mark_action_fulfilled = fulfilled_action

    def finalize(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None


__all__ = [
    "Participant",
    "action_write_initial_data",
    "action_write_iteration_checkpoint",
    "action_read_iteration_checkpoint",
]
