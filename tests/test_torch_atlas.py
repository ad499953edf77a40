"""Parity of the port's Atlas (``pipeline/atlas.py``) with the JAX package on
the CPU.

Pieces on inputs built from the same numpy arrays: ``_cross_map_pairs``
(masks exact, points within 1e-5), ``merge_map_arrays`` field by field
(integers and bools exact, floats within 1e-6 relative; None at capacity).

The lap of ``tests/test_atlas.py`` (320x240, 600 features, loop closing off:
an orbit, ``LOST_PATIENCE + 3`` blank frames, a revisit) in both packages,
on the JAX run's two-view draws (``MonoSLAM._minimal_sets``) and merge draws
(``AtlasSLAM._merge_sets``, ``PRNGKey(slot)``'s sets): maps created, merges,
the merge's frame, slot and candidate, keyframes, the merged database's
rows, and the positions of the stored map's frames.  On the JAX run's own
snapshots at its merge: ``merge_map_arrays``, the spanning-tree weld,
``_remainder_pose_graph`` (poses within 1e-4), ``_merged_loop_closer`` (rows
and ``present`` equal).  The JAX package runs its single-device branches
(``jax.device_count`` reads 1).

The JAX package's faults, shown in both packages (ROADMAP Queue 3): a merge
leaves the incoming map's recycled slots, its relocalisation database's rows
and its keyframe-relative trajectory records at their old slot numbers,
which then name keyframes of the stored map; the port shifts them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import atlas as jatlas
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline.system import FrameRecord as JRecord
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline import atlas as tatlas
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline.system import FrameRecord, MonoSLAM
from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory
from test_torch_sim3 import jax_sim3_sets
from test_torch_twoview import jax_minimal_sets

W, H = 320, 240
PARAMS = (260.0, 260.0, 159.5, 119.5)
CFG_KW = dict(width=W, height=H, n_features=600, max_keyframes=64, max_map_points=8192,
              local_window=4, kf_max_interval=3, kf_tracked_ratio=1.5, vocab_words=256)
CPU = torch.device("cpu")
N_A, REVISIT = 18, (6, 20)
# put into the incoming map before its merge: a recycled slot, and a
# record relative to one of its keyframes (the lap merges at the new map's
# first keyframes, before it tracks any frame against them)
FREE_SLOT = 0
REL_SLOT, REL_FRAME = 1, 10_000
# tracked frames against the JAX run's on the same two-view draws: float32
# sums in other orders, one keyframe culled otherwise (measured 1.35 mm)
POS_TOL_M = 3e-3
CAND_FRAMES = 3
POSE_GRAPH_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


def t_map(d: dict):
    return tms.from_numpy(d, device=CPU)


def j_map(d: dict):
    return jms.MapArrays(**{k: jnp.asarray(v) for k, v in d.items()})


def random_maps(seed: int, KF=6, NF=48, MP=160):
    """Two maps as numpy dicts: the old one random, the new one seeing the
    same points (descriptors with a few flipped bits, points moved by a
    Sim(3)), with some bindings, features and points invalid."""
    rng = np.random.default_rng(seed)
    cfg = JConfig(camera=JCamera(0, PARAMS), width=W, height=H, n_features=NF,
                  max_keyframes=KF, max_map_points=MP)
    base = jax.device_get(jms.empty_map(cfg))._asdict()

    def one(pos, desc, shift):
        d = {k: np.array(v) for k, v in base.items()}
        ang = rng.normal(0, 0.2, (KF, 3))
        for k in range(KF):
            th = np.linalg.norm(ang[k])
            Kx = np.array([[0, -ang[k, 2], ang[k, 1]], [ang[k, 2], 0, -ang[k, 0]],
                           [-ang[k, 1], ang[k, 0], 0]]) / th
            d["kf_Rcw"][k] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        d["kf_tcw"] = rng.normal(0, 0.3, (KF, 3)).astype(np.float32)
        d["kf_valid"][:] = rng.uniform(size=KF) > 0.15
        d["kf_frame_id"] = (np.arange(KF) * 3 + shift).astype(np.int32)
        mp = np.stack([rng.permutation(MP)[:NF] for _ in range(KF)]).astype(np.int32)
        mp[rng.uniform(size=mp.shape) < 0.2] = -1
        d["kf_mp"] = mp
        d["kf_feat_valid"] = rng.uniform(size=(KF, NF)) > 0.1
        flips = (rng.uniform(size=(KF, NF, 8, 32)) < 0.03).astype(np.uint32)
        noise = (flips << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
        d["kf_desc"] = desc[np.maximum(mp, 0)] ^ noise
        d["kf_xy"] = rng.uniform(0, W, (KF, NF, 2)).astype(np.float32)
        d["kf_level"] = rng.integers(0, 8, (KF, NF)).astype(np.int32)
        d["kf_angle"] = rng.uniform(-3, 3, (KF, NF)).astype(np.float32)
        d["kf_uvr"] = np.where(rng.uniform(size=(KF, NF)) < 0.5, -1.0,
                               rng.uniform(0, W, (KF, NF))).astype(np.float32)
        d["kf_parent"] = np.array([-1] + list(rng.integers(-1, 3, KF - 1)), np.int32)
        d["mp_pos"] = pos.astype(np.float32)
        d["mp_valid"] = rng.uniform(size=MP) > 0.1
        d["mp_desc"] = desc
        d["mp_normal"] = rng.normal(size=(MP, 3)).astype(np.float32)
        d["mp_dmin"] = rng.uniform(0.5, 1, MP).astype(np.float32)
        d["mp_dmax"] = rng.uniform(2, 6, MP).astype(np.float32)
        d["mp_ref_kf"] = rng.integers(0, KF, MP).astype(np.int32)
        d["mp_nobs"] = rng.integers(1, 6, MP).astype(np.int32)
        d["mp_visible"] = rng.integers(1, 9, MP).astype(np.int32)
        d["mp_found"] = rng.integers(1, 9, MP).astype(np.int32)
        d["obs_mat"] = rng.uniform(size=(KF, MP)) < 0.2
        return d

    pos = rng.uniform(-2, 2, (MP, 3)) + np.array([0, 0, 4.0])
    desc = rng.integers(0, 2 ** 32, (MP, 8), dtype=np.uint64).astype(np.uint32)
    old = one(pos, desc, 0)
    new = one(1.3 * pos + 0.2, desc, 100)
    return old, new


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_map_pairs(seed):
    old, new = random_maps(seed)
    for sn, so in ((0, 1), (2, 4), (5, 3)):
        jx_old, jx_new, jok = jatlas._cross_map_pairs(j_map(new), jnp.int32(sn), j_map(old),
                                                      jnp.int32(so))
        tx_old, tx_new, tok = tatlas._cross_map_pairs(t_map(new), sn, t_map(old), so)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tok.sum() >= 3  # mutual matches of points the two keyframes share
        np.testing.assert_allclose(tx_old.numpy(), np.asarray(jx_old), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tx_new.numpy(), np.asarray(jx_new), rtol=0, atol=1e-5)


def _hold_map(tm: dict, jm: dict, rtol=1e-6, atol=1e-6):
    assert set(tm) == set(jm)
    for k in jm:
        a, b = np.asarray(jm[k]), tm[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _sim3(rng):
    ang = rng.normal(0, 0.3, 3)
    R = np.asarray(torch.linalg.matrix_exp(torch.tensor(
        [[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]], [-ang[1], ang[0], 0]])), np.float32)
    return R, rng.normal(0, 0.5, 3).astype(np.float32), np.float32(rng.uniform(0.7, 1.4))


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_map_arrays(seed):
    old, new = random_maps(seed)
    R, t, s = _sim3(np.random.default_rng(seed + 10))
    n_kf_old, n_mp_old, n_kf_new, n_mp_new = 3, 70, 3, 80
    jst = jatlas.StoredMap(m=j_map(old), n_kf=n_kf_old, n_mp=n_mp_old, db=None, trajectory=[])
    tst = tatlas.StoredMap(m=t_map(old), n_kf=n_kf_old, n_mp=n_mp_old, db=None, trajectory=[])
    jout = jatlas.merge_map_arrays(jst, j_map(new), n_kf_new, n_mp_new,
                                   (jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)))
    tout = tatlas.merge_map_arrays(tst, t_map(new), n_kf_new, n_mp_new,
                                   (torch.from_numpy(R), torch.from_numpy(t), torch.tensor(s)))
    assert tout[1:] == jout[1:] == (3, 6, 150)
    _hold_map(tms.to_numpy(tout[0]), jax.device_get(jout[0])._asdict())
    # the old map's rows are untouched, the new one's are behind them
    assert np.array_equal(tout[0].kf_desc[:3].numpy(), old["kf_desc"][:3].view(np.int32))
    # past the capacity: None in both packages
    for n_kf, n_mp in ((4, 10), (1, 91)):
        assert jatlas.merge_map_arrays(jst, j_map(new), n_kf, n_mp, (R, t, s)) is None
        assert tatlas.merge_map_arrays(tst, t_map(new), n_kf, n_mp,
                                       (torch.from_numpy(R), torch.from_numpy(t),
                                        torch.tensor(s))) is None


# ---------------------------------------------------------------------------
# the lap of tests/test_atlas.py in both packages


def _frames():
    room = BoxRoom(seed=3)
    poses = orbit_trajectory(20, forward=0.03)
    return poses, [room.render(R, t, PARAMS, W, H) for R, t in poses]


class _Drawn(MonoSLAM):
    """The port's MonoSLAM on the JAX package's two-view draws."""

    def _minimal_sets(self, valid, seed):
        return jax_minimal_sets(valid.numpy(), jax.random.PRNGKey(int(seed)))


def _np_db(db):
    if db is None:
        return None
    to = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    return dict(bow=to(db.bow_mat).copy(), present=np.asarray(db.present).copy(),
                vocab=to(db.vocab).copy(), idf=None if db.idf is None else to(db.idf).copy())


def _relative_record(cls, m):
    """A record of the incoming map tracked at its keyframe ``REL_SLOT``'s
    pose, kept relative to it (as the tracker keeps them)."""
    R = np.asarray(m.kf_Rcw[REL_SLOT], np.float32)
    t = np.asarray(m.kf_tcw[REL_SLOT], np.float32)
    return cls(REL_FRAME, R, t, "OK", 0, ref_slot=REL_SLOT, rel_R=np.eye(3, dtype=np.float32),
               rel_t=np.zeros(3, np.float32))


def _drive(atlas, frames, pkg, snap):
    """tests/test_atlas.py's schedule; before the merge the incoming map
    gets a recycled slot (``FREE_SLOT``) and a relocalisation database with
    a row for each of its keyframes."""
    i = 0
    for k in range(N_A):
        atlas.process(frames[k], i)
        i += 1
    snap["n_kf_a"] = atlas.active.n_kf
    black = np.zeros((H, W), np.float32)
    for _ in range(atlas.LOST_PATIENCE + 3):
        atlas.process(black, i)
        i += 1
    snap["maps_after_blank"] = atlas.maps_created
    snap["stored_db_present"] = np.asarray(atlas.stored[0].db.present).copy()
    for k in range(*REVISIT):
        snap["frame"] = i
        atlas.process(frames[k], i)
        i += 1
        if atlas.merges:
            break
    snap["last_frame"] = i - 1


@pytest.fixture(scope="module")
def laps():
    """(JAX Atlas, port Atlas, the JAX run's snapshots, the port run's)."""
    _, frames = _frames()
    jsnap, tsnap = {}, {}
    jorig = {k: getattr(jatlas.AtlasSLAM, k)
             for k in ("_do_merge", "_remainder_pose_graph", "_merged_loop_closer")}
    jmerge = jatlas.merge_map_arrays

    def j_do_merge(self, st, si, slot, cand, res):
        a = self.active
        a.free_kf_slots = [FREE_SLOT]
        for s_ in range(a.n_kf):
            a._register_reloc_kf(s_)
        a.trajectory.append(_relative_record(JRecord, a.m))
        jsnap["pre"] = dict(
            st=copy.copy(st), m_new=a.m, n_kf=a.n_kf, n_mp=a.n_mp, slot=slot, cand=cand,
            res=jax.device_get(res), kf_off=st.n_kf,
            par_new=np.asarray(a.m.kf_parent)[:a.n_kf], valid_new=np.asarray(a.m.kf_valid)[:a.n_kf],
            par_old=np.asarray(st.m.kf_parent),
            bow_new=[np.asarray(a.reloc_db.bow_mat[s_]) for s_ in range(a.n_kf)])
        return jorig["_do_merge"](self, st, si, slot, cand, res)

    def j_merge(old, new_m, n_kf_new, n_mp_new, S):
        out = jmerge(old, new_m, n_kf_new, n_mp_new, S)
        jsnap["merge"] = dict(S=jax.device_get(S), out=out)
        return out

    def j_remainder(self, a, m_pre, weld_slot):
        jsnap["remainder_in"] = dict(m=a.m, m_pre=m_pre, weld=weld_slot)
        out = jorig["_remainder_pose_graph"](self, a, m_pre, weld_slot)
        jsnap["remainder_out"] = a.m
        return out

    def j_merged_lc(self, a, st, kf_off, n_kf_new):
        jsnap["lc_in"] = dict(st_db=_np_db(st.db), kf_off=kf_off, n_kf_new=n_kf_new,
                              lc_old=None if a.loop_closer is None else _np_db(a.loop_closer.db))
        lc = jorig["_merged_loop_closer"](self, a, st, kf_off, n_kf_new)
        jsnap["lc_out"] = _np_db(lc.db)
        return lc

    t_do_merge = tatlas.AtlasSLAM._do_merge

    def t_merge_hook(self, st, si, slot, cand, res):
        a = self.active
        a.free_kf_slots = [FREE_SLOT]
        for s_ in range(a.n_kf):
            a._register_reloc_kf(s_)
        a.trajectory.append(_relative_record(FrameRecord, a.m))
        tsnap["pre"] = dict(slot=slot, cand=cand, kf_off=st.n_kf, n_kf=a.n_kf,
                            n_inliers=int(res.n_inliers),
                            par_new=a.m.kf_parent.numpy()[:a.n_kf],
                            valid_new=a.m.kf_valid.numpy()[:a.n_kf],
                            par_old=st.m.kf_parent.numpy())
        return t_do_merge(self, st, si, slot, cand, res)

    count = jax.device_count
    jatlas.AtlasSLAM._do_merge = j_do_merge
    jatlas.AtlasSLAM._remainder_pose_graph = j_remainder
    jatlas.AtlasSLAM._merged_loop_closer = j_merged_lc
    jatlas.merge_map_arrays = j_merge
    jax.device_count = lambda *a, **k: 1
    try:
        ja = jatlas.AtlasSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW), jsys.MonoSLAM)
        _drive(ja, frames, "jax", jsnap)
    finally:
        for k, v in jorig.items():
            setattr(jatlas.AtlasSLAM, k, v)
        jatlas.merge_map_arrays = jmerge
        jax.device_count = count
    ta = tatlas.AtlasSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), _Drawn,
                          device=CPU)
    ta._merge_sets = lambda valid, slot: jax_sim3_sets(valid.numpy(), slot)
    ta._do_merge = lambda *args: t_merge_hook(ta, *args)
    _drive(ta, frames, "port", tsnap)
    return ja, ta, jsnap, tsnap


def test_atlas_lap_switches_and_merges_as_jax(laps):
    """The same switch and merge.  The stored map's keyframe culls may
    differ by one keyframe (a redundancy vote on float32 statistics; here
    JAX keeps the keyframe of frame 13, the port that of frame 15), so the
    merge's candidate is held to a keyframe within ``CAND_FRAMES`` frames of
    JAX's and its RANSAC inliers to at least half JAX's (both over the
    gate)."""
    ja, ta, js, ts = laps
    assert js["maps_after_blank"] == ts["maps_after_blank"] == 2
    assert ja.maps_created == ta.maps_created == 2
    assert ja.merges == ta.merges == 1 and ja.n_maps == ta.n_maps == 1
    assert ts["n_kf_a"] == js["n_kf_a"] >= 5
    pj, pt = js["stored_db_present"], ts["stored_db_present"]
    assert pt.sum() == pj.sum() and (pt != pj).sum() <= 2
    # the same merge: frame, slot, slot offset, keyframes
    assert ts["frame"] == js["frame"]
    assert (ts["pre"]["slot"], ts["pre"]["kf_off"], ts["pre"]["n_kf"]) == (
        js["pre"]["slot"], js["pre"]["kf_off"], js["pre"]["n_kf"])
    fid = lambda a, s: int(np.asarray(a.active.m.kf_frame_id)[s])  # noqa: E731
    assert abs(fid(ta, ts["pre"]["cand"]) - fid(ja, js["pre"]["cand"])) <= CAND_FRAMES
    n_in = int(js["pre"]["res"].n_inliers)
    assert ts["pre"]["n_inliers"] >= max(0.5 * n_in, tatlas.AtlasSLAM.MERGE_MIN_INLIERS)
    assert ta.active.n_kf == ja.active.n_kf > js["n_kf_a"]
    # the merged database: the stored map's rows (tests/test_atlas.py holds them)
    np.testing.assert_array_equal(ta.active.loop_closer.db.present, pt)
    np.testing.assert_array_equal(ja.active.loop_closer.db.present, pj)
    # every frame: the same state; the tracked ones at the same position
    n = ts["last_frame"] + 1
    assert [r.state for r in ta.trajectory[:n]] == [r.state for r in ja.trajectory[:n]]
    ok = np.asarray([r.state == "OK" for r in ja.trajectory[:n]])
    assert ok.sum() >= 15
    np.testing.assert_allclose(ta.positions()[:n][ok], ja.positions()[:n][ok], rtol=0,
                               atol=POS_TOL_M)


def test_query_at_a_pre_merge_viewpoint(laps):
    """tests/test_atlas.py:72-86: frame 2's view retrieves a pre-merge
    keyframe from the merged database, in both packages."""
    from orb_slam3_noted_tpu.ops import orb as jorb
    from orb_slam3_noted_tpu_torch.ops import orb as torb

    ja, ta, js, _ = laps
    _, frames = _frames()
    q = jorb.extract_orb(jnp.asarray(frames[2], jnp.float32), n_features=600)
    _, bow = ja.active.loop_closer.db.compute_bow(q.desc, q.valid)
    slots_j, _ = ja.active.loop_closer.db.detect_candidates(bow, np.zeros(64, bool), n_best=3,
                                                            min_rel_score=0.5)
    qt = torb.extract_orb(torch.from_numpy(frames[2].astype(np.float32)), n_features=600)
    _, bow_t = ta.active.loop_closer.db.compute_bow(qt.desc, qt.valid)
    slots_t, _ = ta.active.loop_closer.db.detect_candidates(bow_t, np.zeros(64, bool),
                                                            n_best=3, min_rel_score=0.5)
    assert any(s < js["n_kf_a"] for s in slots_j) and any(s < js["n_kf_a"] for s in slots_t)
    assert slots_t[0] == slots_j[0]


def test_merge_map_arrays_on_the_lap(laps):
    """The JAX run's merge inputs through the port's ``merge_map_arrays``
    (and its world transform through ``_merge_transform``)."""
    _, _, js, _ = laps
    pre, mg = js["pre"], js["merge"]
    st = pre["st"]
    tst = tatlas.StoredMap(m=t_map(jax.device_get(st.m)._asdict()), n_kf=st.n_kf, n_mp=st.n_mp,
                           db=None, trajectory=[])
    S = tuple(torch.from_numpy(np.asarray(x)) for x in mg["S"])
    out = tatlas.merge_map_arrays(tst, t_map(jax.device_get(pre["m_new"])._asdict()), pre["n_kf"],
                                  pre["n_mp"], S)
    assert out[1:] == mg["out"][1:]
    _hold_map(tms.to_numpy(out[0]), jax.device_get(mg["out"][0])._asdict(), rtol=1e-6, atol=1e-6)
    # the world transform from the RANSAC result and the two keyframe poses
    fake = tatlas.AtlasSLAM.__new__(tatlas.AtlasSLAM)
    fake.active = type("A", (), {"m": t_map(jax.device_get(pre["m_new"])._asdict())})()
    res = type("R", (), {k: torch.from_numpy(np.asarray(getattr(pre["res"], k)))
                         for k in ("R", "t", "s")})()
    St = fake._merge_transform(tst, pre["slot"], pre["cand"], res)
    for a, b in zip(St, mg["S"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_spanning_tree_weld(laps):
    """In each package: the incoming map's roots hang off the matched
    keyframe, its other parents shift by the slot offset, the stored map's
    tree is untouched."""
    ja, ta, js, ts = laps
    for a, snap in ((ja, js["pre"]), (ta, ts["pre"])):
        kf_off, n = snap["kf_off"], snap["kf_off"] + snap["n_kf"]
        par = np.asarray(a.active.m.kf_parent)
        want = np.where(snap["par_new"] >= 0, snap["par_new"] + kf_off,
                        np.where(snap["valid_new"], snap["cand"], -1))
        np.testing.assert_array_equal(par[kf_off:n], want)
        np.testing.assert_array_equal(par[:kf_off], snap["par_old"][:kf_off])
        assert (par[kf_off:n] == snap["cand"]).any()


def test_remainder_pose_graph_on_the_jax_snapshot(laps):
    _, _, js, _ = laps
    rin = js["remainder_in"]
    a = type("A", (), {})()
    a.m = t_map(jax.device_get(rin["m"])._asdict())
    cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)
    fake = tatlas.AtlasSLAM.__new__(tatlas.AtlasSLAM)
    fake.cfg = cfg
    fake._remainder_pose_graph(a, t_map(jax.device_get(rin["m_pre"])._asdict()), rin["weld"])
    jm = jax.device_get(js["remainder_out"])
    for k in ("kf_Rcw", "kf_tcw"):
        np.testing.assert_allclose(getattr(a.m, k).numpy(), np.asarray(getattr(jm, k)), rtol=0,
                                   atol=POSE_GRAPH_TOL, err_msg=k)
    np.testing.assert_allclose(a.m.mp_pos.numpy(), np.asarray(jm.mp_pos), rtol=0,
                               atol=10 * POSE_GRAPH_TOL)


def test_merged_loop_closer_on_the_jax_snapshot(laps):
    _, _, js, _ = laps
    li, lo = js["lc_in"], js["lc_out"]
    cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)

    def t_db(d):
        db = KeyFrameDatabase(d["vocab"], cfg.max_keyframes, idf=d["idf"], device=CPU)
        db.bow_mat = torch.from_numpy(d["bow"].copy())
        db.present = d["present"].copy()
        db.present_dev = torch.from_numpy(db.present)
        return db

    fake = tatlas.AtlasSLAM.__new__(tatlas.AtlasSLAM)
    fake.cfg = cfg
    a = type("A", (), {})()
    a.loop_closer = None
    if li["lc_old"] is not None:
        a.loop_closer = type("L", (), {"db": t_db(li["lc_old"]), "enable_gba": True})()
    st = tatlas.StoredMap(m=None, n_kf=0, n_mp=0, db=t_db(li["st_db"]), trajectory=[])
    lc = fake._merged_loop_closer(a, st, li["kf_off"], li["n_kf_new"])
    np.testing.assert_array_equal(lc.db.present, lo["present"])
    np.testing.assert_array_equal(lc.db.present_dev.numpy(), lo["present"])
    np.testing.assert_array_equal(lc.db.bow_mat.numpy(), lo["bow"])
    np.testing.assert_array_equal(lc.db.vocab.numpy().view(np.uint32), lo["vocab"])


def test_bake_trajectory():
    """Relative records become absolute, composed with their keyframe's
    pose at the time of the switch; absolute ones stay."""
    rng = np.random.default_rng(3)
    R, t, _ = _sim3(rng)
    kfR = np.stack([np.eye(3, dtype=np.float32), R])
    kft = rng.normal(size=(2, 3)).astype(np.float32)
    relR, _, _ = _sim3(rng)
    relt = rng.normal(size=3).astype(np.float32)

    def recs(cls):
        return [cls(0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), "OK", 10),
                cls(1, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), "OK", 10, ref_slot=1,
                    rel_R=relR.copy(), rel_t=relt.copy())]

    jrec, trec = recs(JRecord), recs(FrameRecord)
    jatlas.AtlasSLAM._bake_trajectory(type("A", (), {
        "m": type("M", (), {"kf_Rcw": jnp.asarray(kfR), "kf_tcw": jnp.asarray(kft)})(),
        "trajectory": jrec})())
    tatlas.AtlasSLAM._bake_trajectory(type("A", (), {
        "m": type("M", (), {"kf_Rcw": torch.from_numpy(kfR), "kf_tcw": torch.from_numpy(kft)})(),
        "trajectory": trec})())
    for a, b in zip(trec, jrec):
        assert a.ref_slot == b.ref_slot == -1 and a.rel_R is None and b.rel_R is None
        np.testing.assert_allclose(a.Rcw, b.Rcw, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.tcw, b.tcw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trec[1].Rcw, relR @ R, atol=1e-6)


# ---------------------------------------------------------------------------
# the JAX package's faults, and what the port does instead


def test_merge_shifts_recycled_slots_and_frame_ids(laps):
    """Fault: the JAX package's merge keeps the incoming map's recycled
    slot numbers (``system.py:203``, ``:213-214`` pop them), which then name
    live keyframes of the stored map; a later insertion would overwrite
    one.  The port shifts them, and the keyframe frame-id mirror with them."""
    ja, ta, js, _ = laps
    kf_off = js["pre"]["kf_off"]
    assert ja.active.free_kf_slots == [FREE_SLOT]
    assert bool(np.asarray(ja.active.m.kf_valid)[FREE_SLOT])  # a live stored-map keyframe
    assert ta.active.free_kf_slots == [kf_off + FREE_SLOT]
    fids = ta.active.kf_frame_ids
    live = ta.active.m.kf_valid.numpy()
    np.testing.assert_array_equal(fids[live], ta.active.m.kf_frame_id.numpy()[live])
    jf = ja.active.kf_frame_ids
    assert not np.array_equal(jf[np.asarray(ja.active.m.kf_valid)],
                              np.asarray(ja.active.m.kf_frame_id)[np.asarray(ja.active.m.kf_valid)])


def test_merge_shifts_the_relocalisation_database(laps):
    """Fault: with loop closing off the JAX package keeps ``reloc_db`` with
    the incoming map's rows at their own slots (``system.py:958-969``),
    where the merged map holds stored-map keyframes.  The port moves them
    behind the stored map's, as the map."""
    ja, ta, js, _ = laps
    kf_off, n_new = js["pre"]["kf_off"], js["pre"]["n_kf"]
    jdb, tdb = ja.active.reloc_db, ta.active.reloc_db
    assert list(np.flatnonzero(jdb.present)) == list(range(n_new))
    assert list(np.flatnonzero(tdb.present)) == list(range(kf_off, kf_off + n_new))
    for s_ in range(n_new):
        # the JAX row at s_ describes the merged keyframe kf_off + s_
        np.testing.assert_array_equal(np.asarray(jdb.bow_mat[s_]), js["pre"]["bow_new"][s_])
        np.testing.assert_allclose(tdb.bow_mat[kf_off + s_].numpy(), js["pre"]["bow_new"][s_],
                                   rtol=0, atol=1e-6)


def test_merge_reanchors_the_incoming_records(laps):
    """Fault: the JAX package's merge leaves the incoming map's
    keyframe-relative records on their old slots, so ``positions()`` composes
    them with stored-map keyframes.  The port shifts them (and scales their
    translation with the merge's Sim(3)): a record tracked at the incoming
    keyframe's pose lands on that keyframe in the merged map."""
    ja, ta, js, _ = laps
    kf_off = js["pre"]["kf_off"]
    rj, rt = ja.trajectory[-1], ta.trajectory[-1]
    assert rj.frame_id == rt.frame_id == REL_FRAME
    assert rj.ref_slot == REL_SLOT and rt.ref_slot == kf_off + REL_SLOT
    centre = lambda m, s: -np.asarray(m.kf_Rcw[s]).T @ np.asarray(m.kf_tcw[s])  # noqa: E731
    np.testing.assert_allclose(ta.positions()[-1], centre(ta.active.m, kf_off + REL_SLOT),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ja.positions()[-1], centre(ja.active.m, REL_SLOT), rtol=0,
                               atol=1e-5)
    assert np.linalg.norm(ja.positions()[-1] - centre(ja.active.m, kf_off + REL_SLOT)) > 0.01
