"""The kernel lab's traversal prototypes T2, T3 and T4 (hydracore_tpu_torch/
tools/proto_cluster.py, proto_packet.py, proto_packet2.py) against the JAX
package's tools, on the CPU.

Each JAX tool is loaded by file path with pallas_call in interpret mode, as
tests/test_torch_lab.py does. T3's tool does not trace as written: its
pltpu.bitcast of a 0-d payload raises "Not implemented: bitcast 1D" in
interpret mode, so it is loaded with pltpu.bitcast replaced, for 0-d
operands only, by lax.bitcast_convert_type (the same reinterpretation of
the payload's bits), and called with interpret=True itself (its own
interpret=False keyword would override a partial). Inputs come from numpy
with fixed seeds; the port runs its plain versions (CPU tensors). The
kernels are held against the same plain versions on the card by
tests/test_torch_card.py.

Tolerances: XLA:CPU contracts the interpret-mode multiply-adds into FMAs
and sums the MXU variant's 8-term products in its own order, while the
port rounds every operation and sums in index order, so against the tools
  * T2: n_act equal per block, hit masks equal, t within rtol 1e-4, slots
    equal on >= 99% of hits;
  * T3, T4: hit masks equal, t within rtol 1e-4, slots equal on >= 99.9%
    of hits, u and v within atol 1e-4 where the slots agree, visit counts
    within 2% per packet (equal is expected; an FMA-contracted t can move
    a push). On their adversarial_inputs (exact values) t, slots and visits
    equal bit for bit; T3's "sumuv" meets a rewrite of XLA's: the tool's
    one-hot times u is taken as a select, so a loser's 0 * inf is not NaN
    there and a -0.0 winner sums to +0.0, and the test holds the tool to
    that form (test_t3_adversarial_matches_tool).
The packers' arrays and T2's synthetic scene and rays are the tools' bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.tools import proto_cluster as t2
from hydracore_tpu_torch.tools import proto_packet as t3
from hydracore_tpu_torch.tools import proto_packet2 as t4
from tests.test_torch_lab import _bits, _load_tool
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

_BITCAST = pltpu.bitcast


@pytest.fixture(scope="module")
def t2_tool():
    """tools/proto_cluster.py with pallas_call in interpret mode."""
    mp = pytest.MonkeyPatch()
    yield _load_tool("proto_cluster", mp)
    mp.undo()


@pytest.fixture(scope="module")
def t2_inputs():
    """The first 4 blocks of 256 of the tool's probe rays (the first 4 of
    its 1024-ray blocks hold the same rays and more) and synth(256, 16)."""
    return {rb: t2.probe_rays(rb)[:4] for rb in t2.R_BLKS}, t2.synth(256, 16)


def _t2_compare(out_j, outi_j, out_p, outi_p):
    """The tolerances of the module docstring; returns the hits."""
    out_p, outi_p = out_p.numpy(), outi_p.numpy()
    assert out_p.shape == outi_p.shape == out_j.shape
    assert np.array_equal(out_p[..., 2:], np.repeat(out_p[..., :1], 6, -1))
    assert np.array_equal(outi_p, np.repeat(outi_p[..., :1], 8, -1))
    assert np.array_equal(out_p[:, :, 1], out_j[:, :, 1])  # n_act per block
    hj, hp = outi_j[..., 0] >= 0, outi_p[..., 0] >= 0
    assert np.array_equal(hj, hp)
    np.testing.assert_allclose(out_p[..., 0], out_j[..., 0], rtol=1e-4)
    if hj.any():
        assert (outi_p[..., 0][hj] == outi_j[..., 0][hj]).mean() >= 0.99
    return int(hj.sum())


@pytest.mark.parametrize("act", [4, 16])
def test_t2_synth_matches_tool(t2_tool, act):
    for a, b in zip(t2_tool.synth(256, act), t2.synth(256, act)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rblk", t2.R_BLKS)
def test_t2_probe_rays_match_tool(t2_tool, rblk, monkeypatch, capsys):
    """The rays the tool's probe() hands to run(), caught by a stand-in."""
    seen = []

    def fake_run(rays, cb, tris, pk, use_mxu=False, mode=0):
        if not seen:
            seen.append(np.asarray(rays))
        z = jnp.zeros(rays.shape, jnp.float32)
        return z, z.astype(jnp.int32)

    monkeypatch.setattr(t2_tool, "run", fake_run)
    monkeypatch.setattr(t2_tool, "R_BLK", t2_tool.R_BLK)  # probe() sets it
    t2_tool.probe("full", 4, False, rblk)
    assert "us/blk" in capsys.readouterr().out
    assert seen[0].tobytes() == t2.probe_rays(rblk).tobytes()


@pytest.mark.parametrize("use_mxu", [False, True])
@pytest.mark.parametrize("variant", list(t2.MODES))
def test_t2_matches_tool(t2_tool, t2_inputs, variant, use_mxu, monkeypatch):
    rays_by_rb, (cb, tris, pk) = t2_inputs
    rays = rays_by_rb[256][:2]
    mode = t2.MODES[variant]
    monkeypatch.setattr(t2_tool, "R_BLK", 256)
    out_j, outi_j = (np.asarray(x) for x in t2_tool.run(
        jnp.asarray(rays), jnp.asarray(cb), jnp.asarray(tris), jnp.asarray(pk),
        use_mxu=use_mxu, mode=mode))
    before = t2.launches
    out_p, outi_p = t2.proto_cluster(*(torch.tensor(x) for x in (rays, cb, tris,
                                                                pk)),
                                     use_mxu=use_mxu, mode=mode)
    assert t2.launches == before  # the plain version
    hits = _t2_compare(out_j, outi_j, out_p, outi_p)
    n_act = out_j[:, 0, 1]
    if mode == 0:
        assert (n_act > 0).all()
        # the tool's synth leaves pk's plane columns at zero: the MXU
        # variant can never hit; Moller-Trumbore does
        assert (hits == 0) if use_mxu else (hits > 20)
    else:
        assert not n_act.any() and hits == 0


def test_t2_matches_tool_at_1024(t2_tool, t2_inputs, monkeypatch):
    rays_by_rb, (cb, tris, pk) = t2_inputs
    rays = rays_by_rb[1024][:1]
    monkeypatch.setattr(t2_tool, "R_BLK", 1024)
    out_j, outi_j = (np.asarray(x) for x in t2_tool.run(
        jnp.asarray(rays), jnp.asarray(cb), jnp.asarray(tris), jnp.asarray(pk),
        use_mxu=False, mode=0))
    out_p, outi_p = t2.proto_cluster(*(torch.tensor(x) for x in (rays, cb, tris,
                                                                pk)))
    assert _t2_compare(out_j, outi_j, out_p, outi_p) > 50


def test_t2_plucker_hits_with_plane_columns(t2_tool, t2_inputs, monkeypatch):
    """With random plane columns in pk the MXU variant hits, in the tool and
    in the port alike."""
    rays_by_rb, (cb, tris, pk) = t2_inputs
    rays = rays_by_rb[256][:2]
    pk = t2.with_planes(pk)
    monkeypatch.setattr(t2_tool, "R_BLK", 256)
    out_j, outi_j = (np.asarray(x) for x in t2_tool.run(
        jnp.asarray(rays), jnp.asarray(cb), jnp.asarray(tris), jnp.asarray(pk),
        use_mxu=True, mode=0))
    out_p, outi_p = t2.proto_cluster(*(torch.tensor(x) for x in (rays, cb, tris,
                                                                pk)),
                                     use_mxu=True)
    assert _t2_compare(out_j, outi_j, out_p, outi_p) > 20


@pytest.fixture(scope="module")
def t2_adversarial():
    return t2.adversarial_inputs()


@pytest.mark.parametrize("name", t2.ADVERSARIAL)
def test_t2_adversarial_matches_tool(t2_tool, t2_adversarial, name,
                                     monkeypatch):
    """t2.adversarial_inputs through the tool and the plain version: the
    tolerances of the module docstring, and the tied lanes exactly (a ray
    whose tool slot is a TIE_LANES slot has the same slot in the port: the
    highest tied lane of the first cluster)."""
    rays, cb, tris, pk, use_mxu = t2_adversarial[name]
    monkeypatch.setattr(t2_tool, "R_BLK", rays.shape[1])
    modes = (0, 1) if name == "no_entry" else (0,)
    for mode in modes:
        out_j, outi_j = (np.asarray(x) for x in t2_tool.run(
            jnp.asarray(rays), jnp.asarray(cb), jnp.asarray(tris),
            jnp.asarray(pk), use_mxu=use_mxu, mode=mode))
        out_p, outi_p = t2.proto_cluster(
            *(torch.tensor(x) for x in (rays, cb, tris, pk)),
            use_mxu=use_mxu, mode=mode)
        hits = _t2_compare(out_j, outi_j, out_p, outi_p)
        n_act = out_p[:, 0, 1].numpy()
        if mode == 1:
            assert hits == 0 and not n_act.any()
            continue
        assert hits > 10
        sj, sp = outi_j[..., 0], outi_p.numpy()[..., 0]
        tied = [c * t2.K + lane for c, lanes in t2.TIE_LANES for lane in lanes]
        on_tie = np.isin(sj, tied)
        assert np.array_equal(sp[on_tie], sj[on_tie])
        if name.startswith("ties"):
            assert on_tie.sum() > 10
            assert set(sj[on_tie].tolist()) == {2 * t2.K + 127}
        if name == "no_entry":
            assert n_act.tolist() == [16.0, 0.0]
        if name.startswith("lists"):
            assert {0, 1, 2}.issubset(set(n_act.tolist())) and n_act.max() > 8


# ------------------------------------------------------ T3 and T4 walks

def _shim_bitcast(x, ty):
    """pltpu.bitcast for a 0-d operand is lax.bitcast_convert_type."""
    if jnp.ndim(x) == 0:
        return jax.lax.bitcast_convert_type(x, ty)
    return _BITCAST(x, ty)


@pytest.fixture(scope="module")
def rect_scenes():
    js = build_with(JaxBuilder, rects_recipe)
    return js, to_port(js)


def _rays(R, seed=3):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _walk_compare(tj, sj, uj, vj, nj, tp, sp, up, vp, np_):
    """The tolerances of the module docstring."""
    hj, hp = sj >= 0, sp >= 0
    assert np.array_equal(hj, hp) and 20 < hj.sum() < hj.size
    np.testing.assert_allclose(tp, tj, rtol=1e-4)
    same = sj[hj] == sp[hj]
    assert same.mean() >= 0.999
    sel = hj & (sj == sp)
    np.testing.assert_allclose(up[sel], uj[sel], atol=1e-4)
    np.testing.assert_allclose(vp[sel], vj[sel], atol=1e-4)
    assert np.all(np.abs(np_ - nj) <= 0.02 * nj)
    assert (nj > 0).all()


def test_t3_packer_matches_tool(rect_scenes, monkeypatch):
    js, ps = rect_scenes
    monkeypatch.setattr(pltpu, "bitcast", _shim_bitcast)
    mod = _load_tool("proto_packet", monkeypatch)
    for a, b in zip(mod.pack_scene(js), t3.pack_scene(ps)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_t3_matches_tool(rect_scenes, monkeypatch):
    js, ps = rect_scenes
    monkeypatch.setattr(pltpu, "bitcast", _shim_bitcast)
    mod = _load_tool("proto_packet", monkeypatch)
    R = 2 * t3.P
    ro, rd = _rays(R)
    r8 = t3.pack_rays(ro, rd)
    nodes, tris = t3.pack_scene(ps)
    out_j = np.asarray(mod.packet_traverse(jnp.asarray(r8.numpy()),
                                           *mod.pack_scene(js), interpret=True))
    before = t3.launches
    out_p = t3.packet_traverse(r8, nodes, tris)
    assert t3.launches == before
    assert out_p.shape == (8, R) and not out_p[5:].any()
    out_p = out_p.numpy()
    nj = out_j[4].reshape(-1, t3.P)
    assert (nj == nj[:, :1]).all()
    _walk_compare(out_j[0], _bits(out_j[1]), out_j[2], out_j[3], nj[:, 0],
                  out_p[0], _bits(out_p[1]), out_p[2], out_p[3],
                  out_p[4].reshape(-1, t3.P)[:, 0])


@pytest.fixture(scope="module")
def t3_adversarial():
    return t3.adversarial_inputs()


@pytest.mark.parametrize("name", t3.ADVERSARIAL)
def test_t3_adversarial_matches_tool(t3_adversarial, name, monkeypatch):
    """t3.adversarial_inputs through the tool (shimmed) and the plain
    version: the tolerances of the module docstring and, on these exact
    inputs, t, every slot and visit count equal bit for bit. "max_visits"
    runs with MAX_VISITS 96 on both sides, as T4's case does. "sumuv": the
    plain version sums winf[k] * u[k] as the tool's source writes it, so a
    loser's 0 * inf makes u NaN and a -0.0 winner beside a loser of
    positive u sums to +0.0; XLA:CPU rewrites the product of the one-hot
    and u into a select (0 for a loser, whatever its u), so the tool gives
    the winner's own u and v with -0.0 summed to +0.0. The test holds the
    tool to that form of the plain walk's winners bit for bit, and the
    plain version to the tool wherever the two forms agree."""
    rays8, nodes, tris = t3_adversarial[name]
    monkeypatch.setattr(pltpu, "bitcast", _shim_bitcast)
    mod = _load_tool("proto_packet", monkeypatch)
    if name == "max_visits":
        monkeypatch.setattr(mod, "MAX_VISITS", 96)
        monkeypatch.setattr(t3, "MAX_VISITS", 96)
    out_j = np.asarray(mod.packet_traverse(
        jnp.asarray(rays8.numpy()), jnp.asarray(nodes.numpy()),
        jnp.asarray(tris.numpy()), interpret=True))
    out_p = t3.packet_traverse(rays8, nodes, tris).numpy()
    vis_j = out_j[4].reshape(-1, t3.P)
    vis_p = out_p[4].reshape(-1, t3.P)
    assert np.array_equal(_bits(out_p[0]), _bits(out_j[0]))
    assert np.array_equal(_bits(out_p[1]), _bits(out_j[1]))
    assert np.array_equal(vis_p, vis_j)
    if name != "sumuv":
        _walk_compare(out_j[0], _bits(out_j[1]), out_j[2], out_j[3],
                      vis_j[:, 0], out_p[0], _bits(out_p[1]), out_p[2],
                      out_p[3], vis_p[:, 0])
    if name == "edges":
        assert vis_p[8:, 0].tolist() == [1.0] * 8  # enter no child of the root
        assert {8, 24, 32} <= set(_bits(out_p[1]).tolist())  # tie winners
    elif name == "max_visits":
        assert vis_p[0, 0] == 96
    else:
        r = rays8
        own = t3.packet_walk_plain(r[0:3].T, r[4:7].T, r[3], nodes, tris, t3.P,
                                   t3.STACK_D, t3.MAX_VISITS, False, False)
        for row, own_row in ((2, own[2].numpy()), (3, own[3].numpy())):
            select = own_row + np.float32(0.0)  # the select form: -0.0 + 0.0
            assert np.array_equal(_bits(out_j[row]), _bits(select))
            agree = _bits(select) == _bits(out_p[row])
            assert np.array_equal(_bits(out_p[row])[agree],
                                  _bits(out_j[row])[agree])
            assert np.isnan(out_p[row][~agree]).any()  # a loser's 0 * inf
            assert not np.isnan(out_j[row]).any()
            # a -0.0 winner: +0.0 beside a loser of positive term, in both
            assert ((_bits(own_row) == np.int32(-2 ** 31))
                    & (_bits(out_p[row]) == 0)).any()
        # a -0.0 winner whose losers' terms are all -0.0 stays -0.0 here
        kept = _bits(out_p[2]) == np.int32(-2 ** 31)
        assert kept.any() and (_bits(out_j[2])[kept] == 0).all()


def test_t3_tool_does_not_trace_unshimmed(rect_scenes, monkeypatch):
    """Why the shim: the tool's pltpu.bitcast of a 0-d payload raises."""
    js, _ = rect_scenes
    mod = _load_tool("proto_packet", monkeypatch)
    r8 = t3.pack_rays(*_rays(t3.P))
    with pytest.raises(ValueError, match="bitcast"):
        mod.packet_traverse(jnp.asarray(r8.numpy()), *mod.pack_scene(js),
                            interpret=True)


def test_t4_matches_tool(rect_scenes, monkeypatch):
    js, ps = rect_scenes
    mod = _load_tool("proto_packet2", monkeypatch)
    nodes_j, nodesi_j, tris_j = mod.pack_scene(js)
    nodes, tris = t4.pack_scene(ps)
    assert np.asarray(nodes_j).tobytes() == nodes.numpy().tobytes()
    assert np.asarray(nodesi_j).tobytes() == nodes.numpy().tobytes()
    assert np.asarray(tris_j).tobytes() == tris.numpy().tobytes()
    R = 2 * t4.P
    ro, rd = _rays(R)
    r7 = t4.pack_rays(ro, rd)
    out_j, outi_j = (np.asarray(x) for x in mod.packet_traverse(
        jnp.asarray(r7.numpy()), nodes_j, nodesi_j, tris_j))
    before = t4.launches
    out_p, outi_p = t4.packet_traverse(r7, nodes, tris)
    assert t4.launches == before
    assert out_p.shape == out_j.shape and outi_p.shape == outi_j.shape
    out_p, outi_p = out_p.numpy(), outi_p.numpy()
    nj = out_j[3].reshape(-1, t4.P)
    assert (nj == nj[:, :1]).all()
    _walk_compare(out_j[0].reshape(-1), outi_j.reshape(-1),
                  out_j[1].reshape(-1), out_j[2].reshape(-1), nj[:, 0],
                  out_p[0].reshape(-1), outi_p.reshape(-1),
                  out_p[1].reshape(-1), out_p[2].reshape(-1),
                  out_p[3].reshape(-1, t4.P)[:, 0])


@pytest.fixture(scope="module")
def t4_adversarial():
    return t4.adversarial_inputs()


@pytest.mark.parametrize("name", t4.ADVERSARIAL)
def test_t4_adversarial_matches_tool(t4_adversarial, name, monkeypatch):
    """t4.adversarial_inputs through the tool and the plain version: the
    tolerances of the module docstring and, on these exact inputs, every
    slot (the ties: the first k in a leaf, the first leaf popped) and visit
    count equal. "max_visits" runs with MAX_VISITS 96 on both sides, so the
    cut is met at a size the interpret mode can walk; the card holds the
    kernel against the plain version at 16,384 (tests/test_torch_card.py).
    "clamp" walks to its end, and a walk with a stack deep enough not to
    clamp pops more entries: the clamp was met."""
    rays7, nodes, tris = t4_adversarial[name]
    mod = _load_tool("proto_packet2", monkeypatch)
    if name == "max_visits":
        monkeypatch.setattr(mod, "MAX_VISITS", 96)
        monkeypatch.setattr(t4, "MAX_VISITS", 96)
    nj = nodes.numpy()
    out_j, outi_j = (np.asarray(x) for x in mod.packet_traverse(
        jnp.asarray(rays7.numpy()), jnp.asarray(nj),
        jnp.asarray(nj.view(np.int32)), jnp.asarray(tris.numpy())))
    out_p, outi_p = (x.numpy() for x in t4.packet_traverse(rays7, nodes, tris))
    vis_j = out_j[3].reshape(-1, t4.P)
    vis_p = out_p[3].reshape(-1, t4.P)
    _walk_compare(out_j[0].reshape(-1), outi_j.reshape(-1),
                  out_j[1].reshape(-1), out_j[2].reshape(-1), vis_j[:, 0],
                  out_p[0].reshape(-1), outi_p.reshape(-1),
                  out_p[1].reshape(-1), out_p[2].reshape(-1), vis_p[:, 0])
    assert np.array_equal(outi_p, outi_j)
    assert np.array_equal(vis_p, vis_j)
    if name == "edges":
        assert vis_p[:, 0].tolist() == [8.0, 1.0]  # packet 1 enters nothing
        slots = set(outi_p.reshape(-1).tolist())
        assert {8, 24, 32} <= slots  # the tie winners: B, D, E
        assert not {0, 1, 9, 17, 3} & slots  # their equals popped later
    elif name == "clamp":
        assert 0 < vis_p[0, 0] < t4.MAX_VISITS
        r = rays7.reshape(7, -1)
        deep = t3.packet_walk_plain(r[0:3].T, r[3:6].T, r[6], nodes, tris,
                                    t4.P, 4 * t4.STACK_D, t4.MAX_VISITS,
                                    False, False)
        assert int(deep[4][0]) > vis_p[0, 0]
    else:
        assert vis_p[0, 0] == 96


def test_t3_t4_rays_agree_with_each_other(rect_scenes):
    """A ray's t does not depend on its packet: the two walks, and their
    triangles but for ties."""
    _, ps = rect_scenes
    ro, rd = _rays(t4.P, seed=9)
    a = t3.unpack(t3.packet_traverse(t3.pack_rays(ro, rd), *t3.pack_scene(ps)))
    b = t4.unpack(t4.packet_traverse(t4.pack_rays(ro, rd), *t4.pack_scene(ps)))
    assert torch.equal(a[0], b[0])
    assert float((a[1] == b[1]).float().mean()) >= 0.999


@pytest.mark.parametrize("tool", [t3, t4])
def test_packers_refuse_a_tree_too_deep(rect_scenes, tool, monkeypatch):
    _, ps = rect_scenes
    depth = int(ps.wbvh_depth)
    monkeypatch.setattr(tool, "STACK_D", 7 * depth + 1)
    tool.pack_scene(ps)
    monkeypatch.setattr(tool, "STACK_D", 7 * depth)
    with pytest.raises(ValueError, match="STACK_D"):
        tool.pack_scene(ps)


# ------------------------------------------- the port's entry points, on CPU

def test_traverse_lab_mains_run_plain_versions_on_cpu(rect_scenes, capsys):
    """Each tool's main() with device="cpu" runs the plain versions at a
    small size and labels its lines as the host's."""
    _, ps = rect_scenes
    res = t2.main(device="cpu", n_rays=2048, n=1)
    assert len(res) == len(t2.JOBS)
    assert all(r["hits"] == 0 for k, r in res.items() if "mxu=1" in k)
    assert res[t2.job_name("full", 16, False, 256)]["hits"] > 0
    assert res[t2.job_name("full", 16, False, 256)]["bound_by"] == "operations"
    for tool, r in ((t3, 2 * t3.P), (t4, 2 * t4.P)):
        out = tool.main(device="cpu", r=r, n=1, scene=ps)
        assert set(out) == {"coherent", "incoherent"}
        assert out["incoherent"]["t_match"] == 1.0
        assert out["incoherent"]["tri_match"] >= 0.99
    printed = capsys.readouterr().out
    assert printed.count("host clock") == len(t2.JOBS) + 2 * (1 + 2 * 2)
    with pytest.raises(ValueError, match="variant"):
        t3.main("sorted", device="cpu", r=t3.P, scene=ps)


def test_traverse_lab_wrappers_check_their_inputs(rect_scenes):
    _, ps = rect_scenes
    cb, tris, pk = (torch.tensor(x) for x in t2.synth(128, 4))
    rays = torch.tensor(t2.probe_rays(256, 512))
    with pytest.raises(TypeError):
        t2.proto_cluster(rays.double(), cb, tris, pk)
    with pytest.raises(ValueError, match="256 or 1024"):
        t2.proto_cluster(rays.reshape(1, 512, 8), cb, tris, pk)
    with pytest.raises(ValueError, match="mode"):
        t2.proto_cluster(rays, cb, tris, pk, mode=4)
    nodes, tris3 = t3.pack_scene(ps)
    r8 = t3.pack_rays(*_rays(t3.P))
    with pytest.raises(ValueError, match="multiple of 128"):
        t3.packet_traverse(r8[:, :100].contiguous(), nodes, tris3)
    with pytest.raises(TypeError):
        t3.packet_traverse(r8.double(), nodes, tris3)
    with pytest.raises(ValueError, match="CUDA"):  # the profile is the card's
        t3.packet_traverse(r8, nodes, tris3,
                           profile=torch.zeros((1, len(t3.PROFILE)),
                                               dtype=torch.int64))
    nodes4, tris4 = t4.pack_scene(ps)
    r7 = t4.pack_rays(*_rays(t4.P // 2))
    with pytest.raises(ValueError, match="multiple of 1024"):
        t4.packet_traverse(r7, nodes4, tris4)
    r7 = t4.pack_rays(*_rays(t4.P))
    with pytest.raises(ValueError, match="CUDA"):  # the profile is the card's
        t4.packet_traverse(r7, nodes4, tris4,
                           profile=torch.zeros((1, len(t4.PROFILE)),
                                               dtype=torch.int64))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t2.main(n_rays=2048)
