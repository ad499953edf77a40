"""Parity of the port's relocalisation with the JAX package on the CPU.

The lap mirrors ``tests/test_system_modes.py``'s kidnapping test (320x240,
600 features, loop closing off): 14 frames mapped, three blank frames that
lose the track, then mapped views again, here with the camera rolled 90 deg
about its optical axis (put back on its side while the lens was covered):
unrolled, the tracker finds them from its last pose by projection and
nothing relocalises.  Both packages run on the JAX package's two-view and
PnP draws (``MonoSLAM._minimal_sets``, ``MonoSLAM._pnp_sets``).  The port
relocalises at the same frames against the same candidate keyframe, with
re-track inlier counts within 10%.  Its PnP inlier counts are at least 90%
of the JAX run's but may be far above them: the JAX package keeps the SVD's
sign of the DLT's null vector, which leaves about half its hypotheses 180
deg off (``tests/test_torch_pnp.py``), and the port fixes it.

On the JAX run's map and features at its first relocalisation:
``covisibility_matrix`` and ``reloc_matches`` exactly; every PnP hypothesis
that the JAX package solved with the right sign scores within 1 inlier of
the JAX package's; the port's whole ``_try_relocalize`` finds the same
candidate and pose (with the JAX run's PnP pose substituted, within 1e-4 /
1e-3 and the same inlier count, as ``track_frame``).
``final_poses`` on the JAX run's records and keyframe poses within 1e-5.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import orb_slam3_noted_tpu.optim.pnp as jpnp
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.optim import pnp as tpnp
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import system as tsys
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, MonoSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory
from test_torch_pnp import jax_pnp_sets
from test_torch_twoview import jax_minimal_sets

W, H = 320, 240
PARAMS = (260.0, 260.0, 159.5, 119.5)
CFG_KW = dict(width=W, height=H, n_features=600, fps=10.0, max_keyframes=32,
              max_map_points=4096, local_window=5, kf_max_interval=5, enable_loop_closing=False)
CPU = torch.device("cpu")
N_MAPPED, BLANK_IDS, REVISIT, REVISIT_ID0 = 14, (100, 101, 102), range(4, 8), 200
R_ATOL, T_ATOL = 1e-4, 1e-3
INLIER_RTOL = 0.1


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


def tcfg():
    return SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)


@pytest.fixture(scope="module")
def lap():
    """[(frame id, image)]: the mapped frames, the blank ones, the rolled
    revisit."""
    room = BoxRoom(seed=3)
    poses = orbit_trajectory(14, forward=0.03)
    roll = np.asarray(jso3.exp(jax.numpy.asarray([0.0, 0.0, np.pi / 2], jax.numpy.float32)))
    out = [(i, room.render(R, t, PARAMS, W, H)) for i, (R, t) in enumerate(poses[:N_MAPPED])]
    out += [(f, np.full((H, W), 128.0)) for f in BLANK_IDS]
    out += [(REVISIT_ID0 + k, room.render(poses[k][0] @ roll, poses[k][1], PARAMS, W, H))
            for k in REVISIT]
    return out


def jax_draws(valid, seed):
    return jax_minimal_sets(valid.numpy(), jax.random.PRNGKey(int(seed)))


def jax_pnp_draws(valid, seed):
    return jax_pnp_sets(valid.numpy(), jax.random.PRNGKey(int(seed)))


def watch(slam, pnp_log, relocs, snapshots=None):
    """Record each relocalisation attempt's outcome (frame, slot, re-track
    inliers, PnP inliers) on ``slam``; with ``snapshots``, the map, features
    and database at every attempt of the revisit, by frame."""
    orig = slam._try_relocalize

    def attempt(feats, frame_id):
        if snapshots is not None and frame_id >= REVISIT_ID0:
            snapshots[int(frame_id)] = dict(
                m=jax.device_get(slam.m), feats=jax.device_get(feats), frame=int(frame_id),
                db=copy.deepcopy(slam._reloc_database()))
        n_before = len(pnp_log)
        out = orig(feats, frame_id)
        if out is not None:
            relocs.append((int(frame_id), int(slam.last_kf_slot), int(out[2]),
                           pnp_log[-1][2] if len(pnp_log) > n_before else None))
        return out

    slam._try_relocalize = attempt


@pytest.fixture(scope="module")
def laps(lap):
    """The JAX run (its relocalisations, PnP attempts, map at the first
    attempt, final poses) and the port's, both on the JAX draws."""
    js = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    jlog, jrel, snaps = [], [], {}
    orig_pnp, orig_matches = jpnp.pnp_ransac, jtr.reloc_matches
    cur = {}

    def matches(m, cand, feats, cam):
        cur["slot"] = int(cand)
        return orig_matches(m, cand, feats, cam)

    def pnp(Xw, rays, valid, key, **kw):
        res = orig_pnp(Xw, rays, valid, key, **kw)
        jlog.append((int(np.asarray(key)[1]), cur["slot"], int(res.n_inliers), bool(res.success),
                     np.asarray(res.Rcw), np.asarray(res.tcw)))
        return res

    watch(js, jlog, jrel, snaps)
    jpnp.pnp_ransac, jtr.reloc_matches = pnp, matches
    try:
        for fid, img in lap:
            js.process(img, fid)
    finally:
        jpnp.pnp_ransac, jtr.reloc_matches = orig_pnp, orig_matches

    ts = MonoSLAM(tcfg(), device=CPU)
    ts._minimal_sets, ts._pnp_sets = jax_draws, jax_pnp_draws
    tlog, trel = [], []
    orig_tpnp = tsys.PNP.pnp_ransac

    def tpnp(Xw, rays, valid, sets, **kw):
        res = orig_tpnp(Xw, rays, valid, sets, **kw)
        tlog.append((None, None, int(res.n_inliers), bool(res.success), None, None))
        return res

    watch(ts, tlog, trel)
    tsys.PNP.pnp_ransac = tpnp
    try:
        for fid, img in lap:
            ts.process(img, fid)
    finally:
        tsys.PNP.pnp_ransac = orig_tpnp
    assert jrel, "the JAX run never relocalised: the lap no longer tests relocalisation"
    return dict(js=js, jrel=jrel, jlog=jlog, snap=snaps[jrel[0][0]], ts=ts, trel=trel, tlog=tlog)


def test_kidnapped_lap_relocalises_like_jax(laps):
    js, ts, jrel, trel = laps["js"], laps["ts"], laps["jrel"], laps["trel"]
    assert js.reloc_db is not None and ts.reloc_db is not None
    assert [r[:2] for r in trel] == [r[:2] for r in jrel], (trel, jrel)
    for (_, _, nt, pt), (_, _, nj, pj) in zip(trel, jrel):
        assert abs(nt - nj) <= INLIER_RTOL * nj and pt >= (1 - INLIER_RTOL) * pj, (trel, jrel)
    states = lambda s: [r.state for r in s.trajectory]
    assert states(ts) == states(js)
    assert ts.trajectory[-1].state == OK
    np.testing.assert_array_equal(ts.reloc_db.present, js.reloc_db.present)
    np.testing.assert_array_equal(ts.kf_frame_ids, js.kf_frame_ids)


def test_covisibility_matrix_matches_jax(laps):
    mj = laps["snap"]["m"]
    want = np.asarray(jms.covisibility_matrix(jax.tree_util.tree_map(jax.numpy.asarray, mj)))
    got = tms.covisibility_matrix(tms.from_numpy(mj._asdict())).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0 and (np.diag(got) == 0).all()


def test_covisibility_counts_above_256():
    """Keyframes that share 300 to 1200 points: the counts are exact (a bf16
    product would round them to multiples of 2 to 8)."""
    cfg = tcfg()
    m = tms.empty_map(cfg, device=CPU)
    obs = torch.zeros(m.obs_mat.shape, dtype=torch.bool)
    obs[0, :1201] = True
    obs[1, :301] = True
    obs[2, 100:1299] = True
    m = m._replace(obs_mat=obs, kf_valid=torch.arange(obs.shape[0]) < 3)
    cv = tms.covisibility_matrix(m).numpy()
    assert cv[0, 1] == 301 and cv[0, 2] == 1101 and cv[1, 2] == 201 and cv[2, 0] == 1101


def test_reloc_matches_matches_jax(laps):
    snap = laps["snap"]
    mj, fj = snap["m"], snap["feats"]
    m, feats = tms.from_numpy(mj._asdict()), torb.from_numpy(fj._asdict())
    jm = jax.tree_util.tree_map(jax.numpy.asarray, mj)
    jf = jax.tree_util.tree_map(jax.numpy.asarray, fj)
    n_ok = 0
    for slot in np.flatnonzero(mj.kf_valid):
        Xj, rj, okj = (np.asarray(a) for a in jtr.reloc_matches(
            jm, jax.numpy.int32(slot), jf, laps["js"].cam))
        Xt, rt, okt = ttr.reloc_matches(m, int(slot), feats, laps["ts"].cam)
        np.testing.assert_array_equal(okt.numpy(), okj)
        np.testing.assert_array_equal(Xt.numpy(), Xj)
        np.testing.assert_allclose(rt.numpy(), rj, atol=1e-6)
        n_ok += int(okj.sum())
    assert n_ok > 0


@jax.jit
def jax_hypotheses(Xw, rays, valid, sets):
    """Per hypothesis of the JAX package's ``pnp_ransac``: whether its null
    vector came with the sign that gives the rotation block det > 0, and
    its inlier count."""
    jnp = jax.numpy
    X, r = Xw[sets], rays[sets]
    Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)
    z4 = jnp.zeros_like(Xh)
    A = jnp.concatenate([jnp.concatenate([Xh, z4, -r[..., :1] * Xh], -1),
                         jnp.concatenate([z4, Xh, -r[..., 1:2] * Xh], -1)], -2)
    P = jnp.linalg.svd(A)[2][..., -1, :].reshape(-1, 3, 4)
    R, t = jpnp._dlt_p6p(X, r)
    hp = jax.lax.Precision.HIGHEST
    xc = jnp.einsum("hij,nj->hni", R, Xw, precision=hp) + t[:, None, :]
    nrm = jnp.linalg.norm(xc, axis=-1) * jnp.linalg.norm(rays, axis=-1)[None, :]
    cosa = jnp.einsum("hni,ni->hn", xc, rays, precision=hp) / jnp.maximum(nrm, 1e-12)
    inl = (cosa > 0.99996) & (xc[..., 2] > 0) & valid[None, :]
    return jnp.linalg.det(P[..., :3]) > 0, jnp.sum(inl, axis=-1)


def test_pnp_hypotheses_on_the_jax_state(laps):
    """The JAX run's PnP attempt at its first relocalisation, hypothesis by
    hypothesis: where the JAX package's null vector had the right sign, the
    same inlier count within 1; its best is the JAX run's count."""
    snap, jrel = laps["snap"], laps["jrel"]
    frame, slot = jrel[0][:2]
    jm = jax.tree_util.tree_map(jax.numpy.asarray, snap["m"])
    jf = jax.tree_util.tree_map(jax.numpy.asarray, snap["feats"])
    Xw, rays, ok = jtr.reloc_matches(jm, jax.numpy.int32(slot), jf, laps["js"].cam)
    sets = jax_pnp_sets(np.asarray(ok), jax.random.PRNGKey(frame))
    pos, cj = (np.asarray(a) for a in jax_hypotheses(Xw, rays, ok, jax.numpy.asarray(sets.numpy())))
    _, _, inl = tpnp.pnp_hypotheses(*(torch.from_numpy(np.asarray(a)) for a in (Xw, rays, ok)),
                                    sets)
    ct = inl.sum(-1).numpy()
    assert 0 < pos.sum() < len(pos)
    assert np.abs(ct[pos] - cj[pos]).max() <= 1
    assert cj.max() == jrel[0][3] and ct.max() >= cj.max() - 1


def _port_on_jax_state(snap):
    """A port facade holding the JAX run's map and database rows."""
    ts = MonoSLAM(tcfg(), device=CPU)
    ts._pnp_sets = jax_pnp_draws
    ts.m = tms.from_numpy(snap["m"]._asdict())
    jdb = snap["db"]
    ts._register_reloc_kf(int(np.flatnonzero(jdb.present)[0]))  # builds the database
    for slot in np.flatnonzero(jdb.present):
        ts.reloc_db.add(int(slot), torch.from_numpy(np.asarray(jdb.bow_mat[slot])))
    return ts, torb.from_numpy(snap["feats"]._asdict())


@pytest.mark.parametrize("pnp", ["port", "jax"])
def test_try_relocalize_on_the_jax_state(laps, pnp, monkeypatch):
    """The port's whole attempt on the JAX run's map, features and
    database rows: the candidate JAX relocalised to, and its pose.  With
    the port's PnP the re-track starts from another hypothesis (the port
    keeps the ones JAX loses to the null vector's sign), so the pose agrees
    to the re-track's own accuracy, 2e-3 / 1e-2; with the JAX run's PnP pose
    substituted, to ``track_frame``'s parity, 1e-4 / 1e-3."""
    snap, jrel, jlog = laps["snap"], laps["jrel"], laps["jlog"]
    frame, slot, n_j, _ = jrel[0]
    ts, feats = _port_on_jax_state(snap)
    if pnp == "jax":
        _, _, _, _, Rj, tj = next(a for a in jlog if a[0] == frame and a[1] == slot)
        real = tsys.PNP.pnp_ransac

        def jax_pose(Xw, rays, valid, sets, **kw):
            res = real(Xw, rays, valid, sets, **kw)
            return res._replace(Rcw=torch.from_numpy(Rj), tcw=torch.from_numpy(tj))

        monkeypatch.setattr(tsys.PNP, "pnp_ransac", jax_pose)
    out = ts._try_relocalize(feats, frame)
    assert out is not None and ts.last_kf_slot == slot
    rec = next(r for r in laps["js"].trajectory if r.frame_id == frame)
    r_tol, t_tol = (R_ATOL, T_ATOL) if pnp == "jax" else (2e-3, 1e-2)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(rec.Rcw), atol=r_tol)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(rec.tcw), atol=t_tol)
    assert abs(out[2] - n_j) <= (0 if pnp == "jax" else INLIER_RTOL * n_j), (out[2], n_j)


def test_final_poses_matches_jax(laps):
    """On the JAX run's trajectory records and keyframe poses."""
    js = laps["js"]
    ts = MonoSLAM(tcfg(), device=CPU)
    ts.m = tms.from_numpy(jax.device_get(js.m)._asdict())
    ts.trajectory = [tsys.FrameRecord(r.frame_id, np.asarray(r.Rcw), np.asarray(r.tcw), r.state,
                                      r.n_inliers, r.ref_slot, r.rel_R, r.rel_t)
                     for r in js.trajectory]
    want, got = js.final_poses(), ts.final_poses()
    assert len(got) == len(want) == len(js.trajectory)
    for (Rt, tt), (Rj, tj) in zip(got, want):
        np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(ts.positions(), js.positions(), atol=1e-5)


def test_batch_mode_never_relocalises(laps, lap):
    """As in the JAX package: a batch's lost frames stay lost."""
    ts = MonoSLAM(tcfg(), device=CPU)
    ts._minimal_sets = jax_draws
    for fid, img in lap[:N_MAPPED]:
        ts.process(img, fid)
    calls = []
    ts._try_relocalize = lambda *a: calls.append(a) or None
    rest = lap[N_MAPPED:]
    ts.process_batch([img for _, img in rest], [fid for fid, _ in rest])
    assert not calls and ts.reloc_db is not None
    assert all(r.state != OK for r in ts.trajectory[N_MAPPED:N_MAPPED + len(BLANK_IDS)])


def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("name", ["rgbd_localization_lap", "stereo_slam_lap", "stereo_batch_lap"])
def test_lap_fixture_rotations_are_the_jax_packages(name):
    """``chip_smoke.py`` renders every lap from the camera rotations stored
    in its fixture: they are the JAX package's trajectory's, bit for bit."""
    import base64

    from orb_slam3_noted_tpu.utils.synthetic import orbit_trajectory as jax_orbit

    cs = _chip_smoke()
    ref = cs.load_fixture(cs.FIXTURE.replace("rgbd_localization_lap", name), cs.N_FRAMES)
    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(-1, 3, 3)
    jp = jax_orbit(ref["frames"], forward=ref["forward"], yaw0=ref["yaw0"])
    np.testing.assert_array_equal(rwc, np.stack([R for R, _ in jp]))
    poses = cs.stored_poses(cs.FIXTURE.replace("rgbd_localization_lap", name), cs.N_FRAMES)
    np.testing.assert_array_equal(np.stack([R for R, _ in poses]), rwc)


def test_reloc_fixture_is_the_jax_run():
    """The kidnapped lap's fixture: its frames are the JAX package's
    trajectory (the revisit rolled 90 deg), its PnP draws are what
    ``pnp_ransac`` draws from the frame's key on the stored match mask, each
    a set of distinct matches, and ``chip_smoke.py``'s stand-in for
    ``MonoSLAM._pnp_sets`` hands them out for that frame, candidate and
    mask only."""
    import base64

    from orb_slam3_noted_tpu.utils.synthetic import orbit_trajectory as jax_orbit

    cs = _chip_smoke()
    ref = cs.load_fixture(cs.RELOC_FIXTURE, cs.RELOC_FRAMES)
    assert ref["relocalisations"] and ref["reloc_db_rows"]
    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(-1, 3, 3)
    jp = jax_orbit(ref["trajectory_frames"], forward=ref["forward"], yaw0=ref["yaw0"])
    roll = np.asarray(jso3.exp(jax.numpy.asarray([0.0, 0.0, ref["roll_rad"]], jax.numpy.float32)))
    for fid, k, R in zip(ref["frame_ids"], ref["pose_index"], rwc):
        if k is None:
            assert not R.any()
        else:
            want = jp[k][0].astype(np.float32)
            np.testing.assert_array_equal(R, (want @ roll).astype(np.float32) if fid >= 2000 else want)
    ts = MonoSLAM(SlamConfig(), device=CPU)
    draws = cs.fixture_pnp_draws(ref, ts)
    N = ts.cfg.n_features
    feats = torb.FrameFeatures(
        xy=torch.zeros(N, 2), level=torch.zeros(N, dtype=torch.int32), angle=torch.zeros(N),
        response=torch.zeros(N), desc=torch.zeros(N, 8, dtype=torch.int32),
        valid=torch.zeros(N, dtype=torch.bool))
    for a in ref["pnp_attempts"]:
        valid = np.unpackbits(np.frombuffer(base64.b64decode(a["valid"]), np.uint8),
                              count=a["n"]).astype(bool)
        sets = np.frombuffer(base64.b64decode(a["sets"]), "<i2").reshape(a["shape"])
        np.testing.assert_array_equal(sets, jax_pnp_sets(valid, jax.random.PRNGKey(a["frame_id"])))
        assert valid[sets].all() and all(len(set(r)) == 6 for r in sets.tolist())
        assert a["replayed_inliers"] == a["n_inliers"]
        # the stand-in reads the candidate from reloc_matches, as in the lap
        draws.reloc_matches(ts.m, a["slot"], feats, ts.cam)
        got = draws(torch.from_numpy(valid), a["frame_id"])
        assert np.array_equal(got.numpy(), sets) and draws.asked[-1][3]
        other = valid.copy()
        other[np.flatnonzero(valid)[0]] = False
        for slot, mask in ((a["slot"], other), (a["slot"] + 1, valid)):
            # other matches, or another candidate: the port's own draw
            draws.reloc_matches(ts.m, slot, feats, ts.cam)
            got = draws(torch.from_numpy(mask), a["frame_id"])
            assert got.shape == (tpnp.N_HYP, 6) and not draws.asked[-1][3]
            assert bool(torch.from_numpy(mask)[got].all())
    assert ttr.reloc_matches is draws.original
