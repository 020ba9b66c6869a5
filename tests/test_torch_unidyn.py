"""The port's unidyn modules against the JAX package, on the CPU, at
120-300 particles, with inputs made from numpy seeds.

Every force check runs on mixed-phase inputs (``mixed_blob``: solid in
(0, 1) with some pure rows, fluid = 1 - solid, seeded stress, delpress,
vel, dens and press): on the reference's own tank the drift, velocity
gradient, stress acceleration and mixture terms are exactly 0, so a
check there would test none of that code.

Tolerances:
* forces: those of tests/test_forces_vs_oracle.py, rtol 2e-4, and 1e-3
  for the drift, mixture and transport fields, with atol 1e-6 *
  max(1, max|ref|) (the sums run in another order);
* the granular pass, the split trigger and the update: 1e-6 relative
  (float32 rounding of the same expressions);
* binning, merge partners, merges and splits: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_forces_vs_oracle import mixed_blob
from tpufluids import adapt as jadapt
from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import forces as jforces
from tpufluids import integrate as jintegrate
from tpufluids import scenes as jscenes
from tpufluids import state as jstate
from tpufluids.oracle import state_to_dict
from tpufluids.sph_pallas import unidyn_forces_resident as jax_resident
from tpufluids.sph_pallas import unidyn_forces_rowblock as jax_rowblock
from tpufluids_torch import (adapt, binning, config, convert, forces,
                             integrate, scenes, sph_kernels, state)

CFG = config.UNIDYN_CONFIG
JCFG = jconfig.UNIDYN_CONFIG.replace(max_per_cell=64)
LOOSE = ("solid_drift", "fluid_drift", "mixture_accel", "delsolid",
         "delfluid")
PAIR_FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
               "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
               "delfluid")


def _close(got, ref, name, rtol, atol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _force_close(got, ref, name):
    _close(got, ref, name, 1e-3 if name in LOOSE else 2e-4, 1e-6)


def _both(d):
    """(JAX ParticleState, port ParticleState) holding the arrays ``d``."""
    return (jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.state_from_numpy(d, device="cpu"))


def _mixed(n, seed, span, heavy=False, capacity=None):
    """A mixed-phase blob as numpy arrays; ``heavy``: some masses 2.75 and
    some 3.5 (merged absorbers, split candidates)."""
    d = state_to_dict(mixed_blob(n, seed, JCFG, span=span))
    rng = np.random.default_rng(seed + 200)
    d["dens"] = rng.uniform(9300.0, 9900.0, n).astype(np.float32)
    d["press"] = rng.normal(0.0, 3e4, n).astype(np.float32)
    if heavy:
        u = rng.uniform(size=n)
        d["mass"] = np.where(u < 0.2, 2.75, np.where(u < 0.4, 3.5, 1.0)
                             ).astype(np.float32)
    if capacity:
        pad = capacity - n
        d = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
             for k, v in d.items()}
        d["pid"][n:] = -1
    return d


def _assert_nonzero(r, keys=PAIR_FIELDS):
    """Every column of every field has a nonzero entry (dead rows may hold
    NaN: their dens is 0)."""
    for k in keys:
        x = torch.as_tensor(r[k])
        assert bool((x.reshape(x.shape[0], -1).abs() > 0).any(dim=0).all()), k


# --- binning ---------------------------------------------------------------


def _face_blob(seed):
    """A dense random cloud and a sparse one partly outside the domain,
    with a third of the coordinates exactly on cell faces and half-cell
    planes (float32)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(-0.15, 0.15, (200, 3)),
                          rng.uniform(-1.1, 1.1, (100, 3))])
    on = rng.uniform(size=(300, 3)) < 0.33
    planes = -1.0 + 0.06 * np.concatenate([rng.integers(14, 19, (200, 3)),
                                           rng.integers(0, 34, (100, 3))])
    return np.where(on, planes, pos).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_octant_and_home_count_equal_jax(seed):
    jst = jstate.make_state(_face_blob(seed), cfg=JCFG, capacity=320)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    jorder, jbt = jbinning.sort_tables(jst, JCFG)
    order, bt = binning.sort_tables(tst, CFG)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    for f in ("cid", "cell_start", "in_dom", "home_count", "octant"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(jbt, f)), err_msg=f)
    np.testing.assert_array_equal(binning.octant(tst.pos, CFG).numpy(),
                                  np.asarray(jbinning.octant(jst.pos, JCFG)))
    assert int(bt.home_count.max()) > CFG.subbin_threshold
    assert len(np.unique(bt.octant.numpy())) == 8
    # the base variant's tables stay as they were
    _, base = binning.sort_tables(tst, config.BASE_CONFIG)
    assert base.home_count is None and base.octant is None


def test_octant_divides_where_jitted_jax_multiplies():
    """The port divides by the cell size, as JAX does op by op and as the
    reference's ``int()`` of a quotient does.  Jitted, XLA multiplies by
    float32(1 / cell_size) instead, which moves the tank lattice's
    particles on half-cell planes to the other octant (ROADMAP Queue 3)."""
    jst = jscenes.unidyn_tank(JCFG, nf=2000, nb=808)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    port = binning.octant(tst.pos, CFG).numpy()
    np.testing.assert_array_equal(port, np.asarray(
        jbinning.octant(jst.pos, JCFG)))
    jitted = np.asarray(jax.jit(lambda p: jbinning.octant(p, JCFG))(jst.pos))
    moved = port != jitted
    assert moved.sum() > 100
    # each moved particle has a coordinate on a half-cell plane
    half = (np.asarray(jst.pos, np.float64) + 1.0) / 0.12 % 1.0
    assert (np.abs(half[moved] - 0.5) < 1e-5).any(axis=1).all()


@pytest.mark.parametrize("name", ["BASE_CONFIG", "UNIDYN_CONFIG"])
def test_nan_particle_bins_like_jax(name):
    jcfg, tcfg = getattr(jconfig, name), getattr(config, name)
    pos = np.random.default_rng(4).uniform(-0.5, 0.5, (200, 3))
    pos[17] = np.nan
    pos[90, 1] = np.nan
    jst = jstate.make_state(pos.astype(np.float32), cfg=jcfg)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    order, bt = binning.sort_tables(tst, tcfg)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    fields = ["cid", "cell_start", "in_dom"]
    if name == "UNIDYN_CONFIG":
        fields += ["home_count", "octant"]
    for f in fields:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(jbt, f)), err_msg=f)
    # XLA bins the NaN particles in the domain (cell coordinate 0)
    assert bool(bt.in_dom.all())


# --- the plain pair passes against compute_forces ---------------------------


@pytest.mark.parametrize("merge,subbin,heavy,fix", [
    (False, False, False, False),
    (False, True, False, False),
    (True, False, True, False),
    (True, True, True, False),
    (False, False, True, True),
], ids=["plain", "subbin", "merge-heavy", "merge-subbin-heavy", "drift-fix"])
def test_plain_unidyn_matches_compute_forces(merge, subbin, heavy, fix):
    merge_dist = 0.03 if merge else -10.0
    jcfg, tcfg = (JCFG.replace(merge_dist=merge_dist),
                  CFG.replace(merge_dist=merge_dist))
    jst, tst = _both(_mixed(150, 7, 0.15, heavy=heavy))

    def drift_fix(s, f):
        return s * 0.5, f * 2.0

    kw = dict(subbin_parity=subbin, subbin_threshold=6,
              drift_fix=drift_fix if fix else None)
    sorted_state, jbt = jbinning.sort_by_cell(jst, jcfg)
    assert int(jbt.overflow) == 0
    ref = jforces.compute_forces(sorted_state, jbt, jcfg, **kw)
    _, bt = binning.sort_tables(tst, tcfg)
    acc = forces.compute_forces(tst, bt, tcfg, **kw)
    rows = np.asarray(jbt.order)          # pool row of each sorted row
    for f in ref._fields:
        got, want = getattr(acc, f).numpy()[rows], np.asarray(getattr(ref, f))
        if f == "merge_partner":
            want = np.where(want >= 0, rows[np.clip(want, 0, None)], -1)
            np.testing.assert_array_equal(got, want)
            assert (want >= 0).any() == merge
        elif f == "split_trigger":
            np.testing.assert_array_equal(got, want)
            assert want.any() == heavy
        else:
            _force_close(got, want, f)
    _assert_nonzero(acc._asdict())
    if subbin:
        full = forces.compute_forces(tst, bt, tcfg)
        assert not torch.allclose(full.sum_w, acc.sum_w)


@pytest.mark.parametrize("kernel,subbin,merge", [
    ("resident", None, False), ("resident", 6, True),
    ("rowblock", None, True), ("rowblock", 6, False),
])
def test_plain_unidyn_matches_pallas_interpret(kernel, subbin, merge):
    # in the domain: the Pallas kernels floor cell coordinates where the
    # binning truncates, which differs only below a low face
    merge_dist = 0.03 if merge else -10.0
    jcfg, tcfg = (JCFG.replace(merge_dist=merge_dist),
                  CFG.replace(merge_dist=merge_dist))
    jst, tst = _both(_mixed(140, 3, 0.5, capacity=160))
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    with pltpu.force_tpu_interpret_mode():
        fn = jax_resident if kernel == "resident" else jax_rowblock
        ref = fn(jst, jbt, jcfg, order=jorder, subbin_threshold=subbin)
    order, bt = binning.sort_tables(tst, tcfg)
    plain = getattr(sph_kernels, f"unidyn_forces_{kernel}_plain")
    got = plain(tst, bt, tcfg, order, subbin_threshold=subbin)
    alive = tst.alive.numpy()     # Pallas leaves NaN in the dead rows
    for f in PAIR_FIELDS:
        _force_close(got[f].numpy()[alive], np.asarray(ref[f])[alive], f)
    np.testing.assert_array_equal(got["has_pair"].numpy(),
                                  np.asarray(ref["has_pair"]))
    np.testing.assert_array_equal(got["merge_partner"].numpy(),
                                  np.asarray(ref["merge_partner"]))
    assert (got["merge_partner"] >= 0).any() == merge
    assert int(got["overflow"]) == int(ref["overflow"]) == 0
    _assert_nonzero(got)


def test_chunked_plain_unidyn_pass_is_exact(monkeypatch):
    tcfg = CFG.replace(merge_dist=0.03)
    _, tst = _both(_mixed(200, 5, 0.2, heavy=True, capacity=224))
    _, bt = binning.sort_tables(tst, tcfg)
    whole = forces.unidyn_pair_pass(tst, bt, tcfg, 6)
    monkeypatch.setattr(forces, "CHUNK_SLOTS", 700)
    chunked = forces.unidyn_pair_pass(tst, bt, tcfg, 6)
    for k, v in whole.items():
        assert torch.allclose(chunked[k], v, rtol=0, atol=0,
                              equal_nan=True), k
    dead = ~tst.alive
    assert bool((whole["sum_w"][dead] == 0).all())
    assert bool((whole["merge_partner"][dead] == -1).all())


def test_unidyn_wrappers_run_plain_on_cpu():
    _, tst = _both(_mixed(150, 8, 0.2))
    order, bt = binning.sort_tables(tst, CFG)
    want = forces.unidyn_pair_pass(tst, bt, CFG, 6)
    before = sph_kernels.launch_counts()
    for got in (sph_kernels.unidyn_forces_resident(tst, bt, CFG, order,
                                                   subbin_threshold=6),
                sph_kernels.unidyn_forces_rowblock(tst, bt, CFG, order,
                                                   subbin_threshold=6)):
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert sph_kernels.launch_counts() == before
    assert set(before) == {"base_forces_rowblock", "unidyn_forces_resident",
                           "unidyn_forces_rowblock"}
    assert sph_kernels.launch_counts("unidyn_forces_resident") == {
        "unidyn_forces_resident": before["unidyn_forces_resident"]}


def test_pure_tank_zeroes_the_mixture_terms_and_mixed_phase_does_not():
    """Why the kernel checks run on ``scenes.mixed_phase``: the tank's
    fluid is pure (solid 0) and its walls pure sand, so its drift,
    velocity gradient, stress acceleration and mixture terms are 0."""
    tank = scenes.unidyn_tank(CFG, nf=2000, nb=808, device="cpu")
    for st, pure in ((tank, True), (scenes.mixed_phase(tank, 1), False)):
        order, bt = binning.sort_tables(st, CFG)
        r = sph_kernels.unidyn_forces_resident(st, bt, CFG, order,
                                               subbin_threshold=6)
        if pure:
            for k in ("vel_grad", "stress_accel", "solid_drift",
                      "fluid_drift", "mixture_accel", "delsolid"):
                assert bool((r[k] == 0).all()), k
        else:
            _assert_nonzero(r)
            b = st.boundary
            assert bool((st.solid[b] == 1).all())
            assert bool(((st.solid > 0) & (st.solid < 1)).any())
            assert torch.allclose(st.fluid, 1 - st.solid, rtol=0, atol=1e-7)


def test_unidyn_wrappers_reject_bad_arguments():
    _, tst = _both(_mixed(40, 9, 0.2))
    order, bt = binning.sort_tables(tst, CFG)
    meta = tst.replace(**{f: getattr(tst, f).to("meta")
                          for f in state.FIELDS})
    for fn in (sph_kernels.unidyn_forces_resident,
               sph_kernels.unidyn_forces_rowblock):
        with pytest.raises(ValueError, match="meta"):
            fn(meta, bt, CFG, order)
        with pytest.raises(ValueError, match="stress"):
            fn(tst.replace(stress=tst.stress.reshape(-1, 9)), bt, CFG, order)
        with pytest.raises(ValueError, match="unidyn variant"):
            fn(tst, bt, config.BASE_CONFIG, order)
        with pytest.raises(ValueError, match="octant"):
            fn(tst, bt._replace(octant=None), CFG, order, subbin_threshold=6)


# --- granular pass, split trigger, update ------------------------------------


def _update_inputs(seed):
    """A state whose rows cross the walls (|x|, |y|, |z| > 0.98) and the
    floor-recycle plane (z < -0.89), and force sums with split triggers."""
    rng = np.random.default_rng(seed)
    n = 256
    d = _mixed(200, seed, 0.2, heavy=True, capacity=n)
    d["pos"][:200] = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
    d["acc"] = rng.normal(0.0, 5.0, (n, 3)).astype(np.float32)
    d["diffusion"] = rng.normal(0.0, 10.0, (n, 3)).astype(np.float32)
    d["split"] = rng.uniform(size=n) < 0.2
    d["stress"] = rng.normal(0.0, 3e4, (n, 3, 3)).astype(np.float32)
    f32 = np.float32
    acc = dict(
        sum_w=rng.uniform(0.0, 6000.0, n).astype(f32),
        dpress=rng.normal(0.0, 5.0, (n, 3)).astype(f32),
        diffusion=rng.normal(0.0, 100.0, (n, 3)).astype(f32),
        vel_grad=rng.normal(0.0, 3.0, (n, 3, 3)).astype(f32),
        stress_accel=rng.normal(0.0, 1.0, (n, 3)).astype(f32),
        solid_drift=rng.normal(0.0, 0.01, (n, 3)).astype(f32),
        fluid_drift=rng.normal(0.0, 0.01, (n, 3)).astype(f32),
        mixture_accel=rng.normal(0.0, 1.0, (n, 3)).astype(f32),
        delsolid=rng.normal(0.0, 30.0, n).astype(f32),
        delfluid=rng.normal(0.0, 0.5, n).astype(f32),
        stress_scaled=d["stress"],
        stress_rate=rng.normal(0.0, 10.0, (n, 3, 3)).astype(f32),
        split_trigger=rng.uniform(size=n) < 0.3,
        merge_partner=np.full(n, -1, np.int32))
    pos = d["pos"][d["alive"]]
    assert (np.abs(pos) > 0.98).any(axis=0).all()
    assert (pos[:, 2] < -0.89).sum() > 5
    return d, acc


def test_granular_pass_and_split_trigger_match_jax():
    d, a = _update_inputs(21)
    d["press"][::3] *= -1.0                 # some negative pressures
    jst, tst = _both(d)
    jcfg = jconfig.UNIDYN_CONFIG
    ref = jforces.granular_pass(jst, jnp.asarray(a["vel_grad"]), jcfg)
    got = forces.granular_pass(tst, torch.from_numpy(a["vel_grad"]), CFG)
    for name, g, r in zip(("stress_scaled", "stress_rate"), got, ref):
        _close(g.numpy(), r, name, 1e-6, 1e-6)
    # the yield scaling bit some rows, and solid = 0 rows kept their stress
    assert not np.allclose(got[0].numpy(), d["stress"])
    has_pair = np.random.default_rng(3).uniform(size=len(d["pid"])) < 0.8
    rs = jforces.compute_split_trigger(jst, jnp.asarray(a["diffusion"]),
                                       jnp.asarray(has_pair), jcfg)
    gs = forces.compute_split_trigger(tst, torch.from_numpy(a["diffusion"]),
                                      torch.from_numpy(has_pair), CFG)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    assert gs.any() and not gs.all()


def test_unidyn_update_matches_jax():
    d, a = _update_inputs(22)
    jst, tst = _both(d)
    jacc = jforces.ForceAccum(**{k: jnp.asarray(v) for k, v in a.items()})
    tacc = forces.ForceAccum(**{
        k: torch.from_numpy(np.asarray(v).astype(np.int64)
                            if k == "merge_partner" else v)
        for k, v in a.items()})
    ref = state_to_dict(jintegrate.update(jst, jacc, jconfig.UNIDYN_CONFIG))
    got = convert.state_to_numpy(integrate.update(tst, tacc, CFG))
    for f in state.FIELDS:
        _close(got[f], ref[f], f, 1e-6, 1e-6)
    # the walls clamped z, the floor recycled, splits nudged and reset
    assert not np.array_equal(got["pos"], d["pos"])
    assert (got["mass"][a["split_trigger"]] == 1.0).all()
    assert got["split"].sum() > d["split"].sum()


# --- merges and splits ------------------------------------------------------


def test_apply_merges_matches_jax():
    d = _mixed(120, 12, 0.2, capacity=128)
    jst, tst = _both(d)
    rng = np.random.default_rng(5)
    partner = rng.integers(-1, 128, 128)
    # mutual pairs, a self pick and a pick of a dead row
    for a, b in ((3, 40), (7, 8), (100, 2), (55, 56)):
        partner[a], partner[b] = b, a
    partner[9] = 9
    partner[10] = 125
    ref = state_to_dict(jadapt.apply_merges(
        jst, jnp.asarray(partner.astype(np.int32)), jconfig.UNIDYN_CONFIG))
    got = convert.state_to_numpy(adapt.apply_merges(
        tst, torch.from_numpy(partner), CFG))
    for f in state.FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert got["alive"].sum() <= d["alive"].sum() - 4
    assert (got["mass"] == CFG.merge_mass_new).sum() >= 4
    assert int(adapt.count_alive(convert.state_from_numpy(got, device="cpu"))) == int(
        jadapt.count_alive(jstate.ParticleState(**{
            k: jnp.asarray(v) for k, v in ref.items()})))


@pytest.mark.parametrize("n_alive", [100, 124], ids=["free", "too-few"])
def test_apply_splits_matches_jax(n_alive):
    d = _mixed(n_alive, 13, 0.2, capacity=128)
    d["split"][:n_alive] = np.random.default_rng(6).uniform(
        size=n_alive) < 0.1
    d["split"][n_alive + 1] = True          # a dead row's flag is ignored
    jst, tst = _both(d)
    ref = state_to_dict(jadapt.apply_splits(jst, jconfig.UNIDYN_CONFIG))
    got = convert.state_to_numpy(adapt.apply_splits(tst, CFG))
    for f in state.FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    want = (d["split"] & d["alive"] & ~d["boundary"]).sum()
    served = min(want, 128 - n_alive)
    assert want > 128 - n_alive or n_alive == 100
    assert got["alive"].sum() == n_alive + served
    assert got["split"].sum() < d["split"].sum()
