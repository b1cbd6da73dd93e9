"""Port parity: the coupled solver (fem_shell_tpu_torch/coupling) against
the JAX package's fem_shell_tpu/coupling, on the CPU.

- the XML parser, field by field, on the tower XML and on a variant in
  the reference's other dialect (``acceleration:`` tag, values under
  ``<data>``, no ``solver-interface`` wrapper, an m2n host);
- nearest-neighbour indices, IQN-ILS and constant relaxation on the same
  seeded sequences (1e-13);
- a socket round trip on a port of its own (a JAX peer talks to a port
  peer);
- the tower's interface nodes;
- the 30-step tower demo against the JAX run_demo's: per-step solutions
  within 1e-10 of max|u|, the same coupling iterations in every step, CG
  iterations within 2, the tip following 1 + sin(t / 25.01);
- the two coupled CLIs over TCP for 3 steps against the in-process run
  (1e-12), writing the Exodus series;
- run_structure(dtype=float32) for two steps against the JAX adapter's
  f32 run (5e-3 of max|u|, the same coupling iterations);
- devices > 1 with a transport the host cannot give (nccl on the CPU)
  raising before any transport opens, and the structure CLI passing
  --devices and --backend on to run_structure (the sharded run itself:
  tests/test_torch_parallel_entry.py);
- make_timestep_writer's Exodus series and VTU files against the JAX
  writer's bytes.

No test binds the JAX tests' port 50901 or the tower XML's 50077: each
socket test takes a free port and writes its XML copy under tmp_path.
Every thread is joined with a timeout, so a lost peer fails the test.
"""
import dataclasses
import filecmp
import queue
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.coupling import accel as jaccel
from fem_shell_tpu.coupling import adapter as jadapter
from fem_shell_tpu.coupling import config as jconfig
from fem_shell_tpu.coupling import demo as jdemo
from fem_shell_tpu.coupling import fluid_dummy as jfluid
from fem_shell_tpu.coupling import m2n as jm2n
from fem_shell_tpu.coupling import mapping as jmapping
from fem_shell_tpu.coupling.structure_cli import make_timestep_writer as jmake_timestep_writer
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu_torch import Material
from fem_shell_tpu_torch.coupling import accel, adapter, config, demo, fluid_cli, fluid_dummy, m2n, mapping
from fem_shell_tpu_torch.coupling import structure_cli
from fem_shell_tpu_torch.coupling.structure_cli import make_timestep_writer
from fem_shell_tpu_torch.io.exodus import read_exodus_summary
from fem_shell_tpu_torch.mesh import write_xdr

JOIN_S = 120

_DIALECT = """<?xml version="1.0"?>
<precice-configuration dimensions="3">
  <data:vector name="Forces"/>
  <data:vector name="Displacements"/>
  <mesh name="A_Nodes"><use-data name="Forces"/><use-data name="Displacements"/></mesh>
  <mesh name="B_Nodes"><use-data name="Forces"/><use-data name="Displacements"/></mesh>
  <m2n:sockets from="A" to="B" port="50123" host="10.0.0.7"/>
  <participant name="A">
    <use-mesh name="A_Nodes" provide="yes"/>
    <use-mesh name="B_Nodes" from="B"/>
    <write-data name="Forces" mesh="A_Nodes"/>
    <read-data name="Displacements" mesh="A_Nodes"/>
    <mapping:nearest-neighbor direction="write" from="A_Nodes" to="B_Nodes"/>
  </participant>
  <participant name="B">
    <use-mesh name="B_Nodes" provide="yes"/>
    <write-data name="Displacements" mesh="B_Nodes"/>
    <read-data name="Forces" mesh="B_Nodes"/>
  </participant>
  <coupling-scheme:serial-explicit>
    <participants first="A" second="B"/>
    <max-time value="0.5"/>
    <exchange data="Forces" mesh="B_Nodes" from="A" to="B" initialize="yes"/>
    <exchange data="Displacements" mesh="B_Nodes" from="B" to="A"/>
    <relative-convergence-measure data="Displacements" mesh="B_Nodes" limit="3e-4"/>
    <acceleration:IQN-ILS>
      <data name="Displacements" mesh="B_Nodes">
        <initial-relaxation value="0.25"/>
        <max-used-iterations value="7"/>
        <singularity-limit value="1e-6"/>
      </data>
      <timesteps-reused value="2"/>
    </acceleration:IQN-ILS>
  </coupling-scheme:serial-explicit>
</precice-configuration>
"""


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _xml_on_free_port(tmp_path):
    text = open(demo.CONFIG).read()
    assert 'port="50077"' in text
    path = tmp_path / "tower.xml"
    path.write_text(text.replace('port="50077"', f'port="{_free_port()}"'))
    return str(path)


def _join(th):
    th.join(timeout=JOIN_S)
    assert not th.is_alive(), "a coupling peer did not finish"


@pytest.mark.parametrize("which", ["tower", "dialect"])
def test_config_parser_matches_jax(tmp_path, which):
    path = demo.CONFIG
    if which == "dialect":
        path = str(tmp_path / "dialect.xml")
        open(path, "w").write(_DIALECT)
    got, want = config.parse_config(path), jconfig.parse_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if which == "tower":
        assert open(demo.CONFIG).read() == open(jdemo.CONFIG).read()
        assert got.scheme.extrapolation_order == 2 and got.scheme.max_iterations == 40
        assert got.scheme.convergence[0].limit == 1e-5 and got.port == 50077
    else:
        acc = got.scheme.acceleration
        assert (acc.initial_relaxation, acc.max_used_iterations, acc.timesteps_reused,
                acc.singularity_limit) == (0.25, 7, 2, 1e-6)
        assert got.dimensions == 3 and got.host == "10.0.0.7" and got.port == 50123
        assert got.scheme.kind == "serial-explicit" and got.scheme.exchanges[0].initialize


def test_nn_mapping_matches_jax():
    rng = np.random.default_rng(1)
    src, dst = rng.normal(size=(37, 2)), rng.normal(size=(53, 2))
    got = mapping.NearestNeighborMapping(src, dst)
    want = jmapping.NearestNeighborMapping(src, dst)
    np.testing.assert_array_equal(got.idx, want.idx)
    vals = rng.normal(size=(37, 2))
    np.testing.assert_array_equal(got.apply(vals), want.apply(vals))


@pytest.mark.parametrize("kind", ["iqnils", "relaxation"])
def test_acceleration_matches_jax(kind):
    """The same linear fixed point x = A x + b (Picard divergent for
    IQN-ILS, contracting for relaxation) through both packages'
    accelerators, three time windows with a new b, each fed its own
    iterates: every accelerated iterate within 1e-13."""
    rng = np.random.default_rng(0)
    n = 8
    a = rng.normal(size=(n, n))
    a = (1.2 if kind == "iqnils" else 0.6) * a / np.abs(np.linalg.eigvals(a)).max()
    make = {"iqnils": lambda m: m.IQNILS(initial_relaxation=0.1, max_used_iterations=6, timesteps_reused=2),
            "relaxation": lambda m: m.ConstantRelaxation(0.5)}[kind]
    bs = [rng.normal(size=n) for _ in range(3)]
    seqs = []
    for mod in (accel, jaccel):
        acc, x, seq = make(mod), np.zeros(n), []
        for b in bs:
            for _ in range(15):
                x = acc.accelerate(a @ x + b)
                seq.append(x.copy())
            acc.next_timestep()
        seqs.append(np.array(seq))
    got, want = seqs
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    if kind == "iqnils":  # quasi-Newton solves even a divergent fixed point
        x_star = np.linalg.solve(np.eye(n) - a, bs[2])
        assert np.linalg.norm(got[-1] - x_star) < 1e-8 * max(1.0, np.linalg.norm(x_star))


def test_socket_roundtrip_with_a_jax_peer():
    port = _free_port()
    result = {}

    def server():
        t = m2n.SocketTransport.listen("127.0.0.1", port, timeout=30.0)
        result["got"] = t.recv()
        t.send({"pong": np.arange(3)})
        t.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    c = jm2n.SocketTransport.connect("127.0.0.1", port, timeout=30.0)
    c.send({"ping": np.ones((2, 2))})
    back = c.recv()
    c.close()
    _join(th)
    np.testing.assert_array_equal(result["got"]["ping"], np.ones((2, 2)))
    np.testing.assert_array_equal(back["pong"], [0, 1, 2])


def test_tower_interface_matches_jax():
    mesh, jmesh = demo.tower_mesh(), jdemo.tower_mesh()
    np.testing.assert_array_equal(mesh.coords, jmesh.coords)
    iface = mesh.coupling_node_ids()
    np.testing.assert_array_equal(iface, jmesh.coupling_node_ids())
    assert len(iface) == 43
    spos = mesh.coords[iface][:, [0, 2]]  # dead axis y
    fpos = fluid_dummy.tower_grid(2)
    np.testing.assert_array_equal(fpos, jfluid.tower_grid(2))
    d2 = ((spos[:, None] - fpos[None]) ** 2).sum(-1)
    assert d2.min(axis=1).max() < 1e-12


def _tower_run(pkg, steps, rtol=1e-10, **kw):
    """run_demo's coupled run with the structure's transport recording the
    converged flag of every coupling iteration: (result, coupling
    iterations per step)."""
    mods = {"port": (m2n, fluid_dummy, adapter, demo, Material),
            "jax": (jm2n, jfluid, jadapter, jdemo, JMaterial)}[pkg]
    trans, fluid, adapt, dem, mat = mods
    flags = []

    class Recording(trans.InProcessTransport):
        def send(self, obj):
            if "converged" in obj:
                flags.append(obj["converged"])
            super().send(obj)

    a, b = queue.Queue(), queue.Queue()
    ts, tf = Recording(a, b), trans.InProcessTransport(b, a)
    th = threading.Thread(target=lambda: fluid.run_fluid(dem.CONFIG, transport=tf, max_timesteps=steps),
                          daemon=True)
    th.start()
    res = adapt.run_structure(dem.tower_mesh(), mat(nu=0.3, em=1e6, thickness=0.1), dem.CONFIG, dt=0.01,
                              dead_axis="y", transport=ts, rtol=rtol, max_timesteps=steps, **kw)
    _join(th)
    per_step, n = [], 0
    for f in flags:
        n += 1
        if f:
            per_step.append(n)
            n = 0
    return res, per_step


def test_demo_30_steps_matches_jax():
    want, want_steps = _tower_run("jax", 30)
    got, got_steps = _tower_run("port", 30, device="cpu")
    assert got.timesteps == want.timesteps == 30
    assert got_steps == got.step_iterations == want_steps
    assert sum(got_steps) == len(got.iterations) == len(want.iterations)
    assert max(abs(a - b) for a, b in zip(got.iterations, want.iterations)) <= 2
    scale = np.abs(want.solutions).max()
    assert np.abs(got.solutions - want.solutions).max(axis=(1, 2)).max() <= 1e-10 * scale
    tip = np.abs(got.solutions[:, :, 0]).max(axis=1)
    assert np.corrcoef(tip, 1.0 + np.sin(np.arange(30) / 25.01))[0, 1] > 0.999
    perf = got.perf.stats("solve")
    assert perf["n"] == len(got.iterations) and got.perf.stats("setup")["n"] == 1
    # the recorded interface forces reproduce every converged step's load
    mesh = demo.tower_mesh()
    iface = mesh.coupling_node_ids()
    assert got.iface_forces.shape == (30, len(iface), 2)
    load = adapter.interface_load(mesh.n_nodes, iface, got.iface_forces[-1], 2, "y")
    from fem_shell_tpu_torch import ShellSystem

    u = ShellSystem(mesh, Material(nu=0.3, em=1e6, thickness=0.1), device="cpu").solve(load, rtol=1e-12)
    assert np.abs(u.numpy() - got.solutions[-1]).max() <= 1e-8 * np.abs(got.solutions[-1]).max()


def test_clis_over_sockets_match_inprocess(tmp_path, capsys):
    """FEM-shell-precice and FluidSolver analogs over TCP for 3 steps (the
    tower written as .xdr, Exodus output) against the in-process demo."""
    pytest.importorskip("scipy")
    ref, _ = demo.run_demo(max_timesteps=3, verbose=False, device="cpu")
    xml = _xml_on_free_port(tmp_path)
    write_xdr(demo.tower_mesh(), str(tmp_path / "tower.xdr"))
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("fluid", fluid_cli.main([xml, "43", "3"])), daemon=True)
    th.start()
    out = str(tmp_path / "tower.e")
    rc["structure"] = structure_cli.main(
        ["-nu", "0.3", "-e", "1e6", "-t", "0.1", "-mesh", str(tmp_path / "tower.xdr"), "-config", xml,
         "-dt", "0.01", "-axis", "y", "--steps", "3", "-out", out, "--device", "cpu"])
    _join(th)
    assert rc == {"fluid": 0, "structure": 0}
    lines = capsys.readouterr().out
    assert "43 coupling interface nodes" in lines and "Exiting FluidSolver (3 timesteps)" in lines
    summ = read_exodus_summary(out)
    np.testing.assert_allclose(summ["times"], [0.01, 0.02, 0.03])
    for k, name in enumerate(("disp_x", "disp_y", "disp_z", "rot_x", "rot_y", "rot_z")):
        want = ref.solutions[:, :, k]
        assert np.abs(summ["nodal_vars"][name] - want).max() <= 1e-12 * np.abs(ref.solutions).max()


def test_f32_structure_matches_jax():
    """run_structure(dtype=float32), two tower steps to rtol 1e-5, against
    the JAX adapter's f32 run: the same coupling iterations per step and
    every solution within 5e-3 of max|u| of the JAX one and of the port's
    f64 run, returned to the host in f64. The tower's f32 operators (the
    port's the cast of the f64 one) put the solutions 1.9e-3 (port) and
    1.2e-3 (JAX) of max|u| from the f64 run, 8.2e-4 from each other, at
    rtol 1e-5 as at 1e-7: kappa eps32, not the CG's stop."""
    want, want_steps = _tower_run("jax", 2, rtol=1e-5, dtype=jnp.float32)
    got, got_steps = _tower_run("port", 2, rtol=1e-5, dtype=torch.float32, device="cpu")
    ref, _ = _tower_run("port", 2, device="cpu")
    assert got.timesteps == want.timesteps == 2 and got_steps == want_steps == got.step_iterations
    assert got.solutions.dtype == np.float64
    scale = np.abs(ref.solutions).max()
    assert np.abs(got.solutions - want.solutions).max() <= 5e-3 * scale
    assert np.abs(got.solutions - ref.solutions).max() <= 5e-3 * scale


@pytest.mark.parametrize("kw,item", [({"devices": 2, "backend": "nccl"}, "nccl backend runs on CUDA")],
                         ids=["devices"])
def test_unported_options_raise(kw, item):
    """devices > 1 is ported; a transport the host cannot give still
    raises, before any transport opens or rank starts (the tower XML's
    port is never bound: no peer is waiting)."""
    with pytest.raises(ValueError, match=item):
        adapter.run_structure(demo.tower_mesh(), Material(0.3, 1e6, 0.1), demo.CONFIG, device="cpu", **kw)


def test_structure_cli_devices_exits_2(tmp_path, monkeypatch, capsys):
    """--devices no longer exits 2: the CLI passes it and --backend on to
    run_structure."""
    from fem_shell_tpu_torch.mesh import write_xda

    seen = {}

    def fake_run_structure(mesh, material, config, **kw):
        seen.update(kw, n_nodes=mesh.n_nodes)
        return adapter.CoupledRunResult(timesteps=0, solutions=np.zeros((0, mesh.n_nodes, 6)), iterations=[])

    monkeypatch.setattr(adapter, "run_structure", fake_run_structure)
    path = str(tmp_path / "tower.xda")
    write_xda(demo.tower_mesh(), path)
    rc = structure_cli.main(["-nu", "0.3", "-e", "1e6", "-t", "0.1", "-mesh", path, "-config", demo.CONFIG,
                             "-dt", "0.01", "--devices", "2", "--backend", "gloo", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1] == "All done :)"
    assert (seen["devices"], seen["backend"], seen["device"]) == (2, "gloo", "cpu")
    assert seen["n_nodes"] == demo.tower_mesh().n_nodes


def test_timestep_writer_matches_jax(tmp_path):
    """-out name.e: one Exodus time series with the JAX writer's bytes;
    any other name: one displaced-geometry VTU per step; None: inert."""
    pytest.importorskip("scipy")
    mesh = demo.tower_mesh()
    sols = np.random.default_rng(1).normal(size=(3, mesh.n_nodes, 6))
    for make, tag in ((make_timestep_writer, "t"), (jmake_timestep_writer, "j")):
        for out in (str(tmp_path / f"{tag}.e"), str(tmp_path / tag), None):
            write_step, finalize = make(mesh, out, dt=0.25)
            for t, s in enumerate(sols):
                write_step(t, s)
            finalize()
    assert filecmp.cmp(tmp_path / "t.e", tmp_path / "j.e", shallow=False)
    for t in range(3):
        assert filecmp.cmp(tmp_path / f"t_{t:04d}.vtu", tmp_path / f"j_{t:04d}.vtu", shallow=False)
    summ = read_exodus_summary(str(tmp_path / "t.e"))
    np.testing.assert_allclose(summ["times"], [0.25, 0.5, 0.75])
    np.testing.assert_array_equal(summ["nodal_vars"]["disp_z"], sols[:, :, 2])
