"""Result integrity in the port against the JAX package's: the
``IntegrityChecker`` (Freivalds sketches, tile fingerprints, worker
health) and the runner's three corruption seams — the barrier's masked
re-dispatch, first-arrival's realized straggler, the fused window's host
recompute from a replica tile — with the engine's recovery loop.

The checker is NumPy on both sides, so its parity runs here in one process
on the same seeded inputs. The engine cases use ``tests/test_integrity.py``'s
fleet (that of ``tests/test_torch_faults.py``, whose harness this file
reuses, with ``verify_results="always"``), injecting at worker 3, which
wins output rows in every mode (worker 2 is a pure backup: corrupting it
is a noop): both corruption kinds under ``(barrier, 1)`` and ``(first,
4)``, the full arrival x fuse grid for ``result_corruption``, the
uncovered corruption at S = 0, a repeat offender's graylisting, a seeded
corruption schedule, a tile corrupted at a step ``verify_results="sample"``
does not check (the kernel reads the corrupt bits; the target there is a
worker that delivers the corrupted row), and the noop / silent
contracts — each in both executor modes. The reference runs once, in one
subprocess with 4 forced host devices. Tolerance: bitwise everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_faults import (  # noqa: E402
    MODES,
    assert_matches,
    assert_same_bits,
    port,
    reference_fixture,
)

from repro_torch.faults import CORRUPTION_KINDS  # noqa: E402

GRID = [("barrier", 1), ("first", 4)]
FULL_GRID = [("barrier", 1), ("barrier", 4), ("first", 1), ("first", 4)]
ACTION = {"tile_corruption": "restaged", "result_corruption": "quarantined"}
ALWAYS = dict(verify_results="always")
UNVERIFIED_TARGET = {"barrier1": 1, "first4": 2}


def cases():
    """Every engine case of this file: name -> run_case arguments."""
    out = {}
    for arrival, fuse in FULL_GRID:
        g = f"{arrival}{fuse}"
        out[f"clean_{g}"] = dict(arrival=arrival, fuse=fuse, **ALWAYS)
        out[f"result_corruption_{g}"] = dict(
            arrival=arrival, fuse=fuse,
            faults=[("result_corruption", 3, 3)], **ALWAYS)
    for arrival, fuse in GRID:
        g = f"{arrival}{fuse}"
        out[f"tile_corruption_{g}"] = dict(
            arrival=arrival, fuse=fuse, faults=[("tile_corruption", 3, 3)],
            **ALWAYS)
        out[f"clean_s0_{g}"] = dict(arrival=arrival, fuse=fuse, stragglers=0,
                                    **ALWAYS)
        out[f"corrupt_s0_{g}"] = dict(
            arrival=arrival, fuse=fuse, stragglers=0,
            faults=[("result_corruption", 3, 3)], **ALWAYS)
        out[f"graylist_{g}"] = dict(
            arrival=arrival, fuse=fuse, faults=[("result_corruption", 2, 3),
                                                ("result_corruption", 4, 3)],
            **ALWAYS)
        out[f"seeded_{g}"] = dict(arrival=arrival, fuse=fuse,
                                  faults=("seed", fuse, CORRUPTION_KINDS),
                                  **ALWAYS)
        # Step 5 is not a sampled step, and no later step of the run is:
        # nothing repairs the tile before the kernel reads it. The target
        # wins rows of its first stored tile (the one corrupt_tile hits).
        out[f"unverified_{g}"] = dict(
            arrival=arrival, fuse=fuse,
            faults=[("tile_corruption", 5, UNVERIFIED_TARGET[g])],
            verify_results="sample", check=None)
    out["noop_barrier1"] = dict(faults=[("result_corruption", 3, 2)],
                                **ALWAYS)
    out["silent_barrier1"] = dict(faults=[("result_corruption", 3, 3)],
                                  verify_results="off", check=None)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_fixture(tmp_path_factory, "test_torch_integrity")


def run(name, segmented):
    return port(name, segmented, cases())


def actions(out):
    return [r.split(":")[3] for r in out["records"].tolist()]


def integrity(out, key):
    from test_torch_faults import INTEGRITY_KEYS

    return int(out["integrity"][INTEGRITY_KEYS.index(key)])


# ---------------------------------------------------------------------- #
# The checker, host only: port and reference on the same inputs
# ---------------------------------------------------------------------- #
def _fleet():
    """A staged cyclic J = 3 fleet of 4 machines over 8 tiles of 16 rows
    (the port's staging: NumPy, the reference's layout)."""
    from repro_torch.core import make_placement
    from repro_torch.runtime import make_exact_matrix, stage_matrix

    x = make_exact_matrix(128, 0)
    place = make_placement("cyclic", 4, 8, 3)
    sm = stage_matrix(x, place, 16)
    return x, place, sm


def _checkers(**kw):
    from repro.faults.integrity import IntegrityChecker as Ref

    from repro_torch.faults.integrity import IntegrityChecker as Port

    x, place, sm = _fleet()
    args = dict(staged=sm.staged, slot_of=sm.slot_of, holders=place.holders,
                block_rows=16, **kw)
    return x, place, sm, Ref(x, **args), Port(x, **args)


def test_checker_sketch_bank_and_fingerprints_match_reference():
    _, _, _, ref, got = _checkers()
    for k in ("sketches", "chunk_products", "full_products", "chunk_scale",
              "full_scale"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert got.fingerprints == ref.fingerprints and got.fingerprints
    assert got.tile_of == ref.tile_of
    assert got.holders == ref.holders


@pytest.mark.parametrize("exact", [True, False])
def test_checker_checks_and_locate_match_reference(exact):
    from repro.faults.integrity import corrupt_result as ref_corrupt
    from repro.runtime.elastic_runner import quantize_unit

    from repro_torch.faults.integrity import corrupt_result

    x, _, _, ref, got = _checkers(exact=exact)
    rng = np.random.default_rng(1)
    for cols in (None, 3):
        w = (quantize_unit(rng.standard_normal(128)) if cols is None
             else rng.integers(-3, 4, size=(128, cols)).astype(np.float64))
        y = x.astype(np.float64) @ w
        bad_r, bad_p = np.array(y), np.array(y)
        ref_corrupt(bad_r, 37)
        corrupt_result(bad_p, 37)
        assert bad_r.tobytes() == bad_p.tobytes()
        for step in (0, 1):
            for yy in (y, bad_p):
                assert got.check_output(step, yy, w) == \
                    ref.check_output(step, yy, w)
                assert got.locate(step, yy, w) == ref.locate(step, yy, w)
                for chunks in ([2, 5], [0, 1, 3], []):
                    assert got.check_chunks(step, yy, w, chunks) == \
                        ref.check_chunks(step, yy, w, chunks)
    assert got.counters() == ref.counters()
    assert got.counters()["sketch_failures"] > 0


def test_checker_audit_donor_restage_and_recompute_match_reference():
    from repro.faults.integrity import corrupt_tile as ref_corrupt
    from repro.runtime.elastic_runner import quantize_unit

    from repro_torch.faults.integrity import corrupt_tile

    _, place, sm, ref, got = _checkers()
    st_r, st_p = np.array(sm.staged), np.array(sm.staged)
    assert got.audit_tiles(st_p) == ref.audit_tiles(st_r) == []
    g = int(np.flatnonzero(sm.slot_of[1] >= 0)[0])
    s = int(sm.slot_of[1, g])
    ref_corrupt(st_r[1, s])
    corrupt_tile(st_p[1, s])
    assert st_p.tobytes() == st_r.tobytes()
    assert got.audit_tiles(st_p) == ref.audit_tiles(st_r) == [(1, s, g)]
    for alive in (range(4), [1], [0, 1]):
        assert got.find_donor(st_p, g, 1, alive) == \
            ref.find_donor(st_r, g, 1, alive)
    donor = got.find_donor(st_p, g, 1, range(4))
    w = quantize_unit(np.random.default_rng(5).standard_normal(128))
    for chunk in range(8):
        h = place.holders[chunk][0]
        a = got.replica_recompute(st_p, h, chunk, w, 16)
        b = ref.replica_recompute(st_r, h, chunk, w, 16)
        assert a.tobytes() == b.tobytes()
    got.restage(st_p, 1, s, g, donor)
    ref.restage(st_r, 1, s, g, donor)
    assert st_p.tobytes() == st_r.tobytes() == sm.staged.tobytes()
    assert got.audit_tiles(st_p) == ref.audit_tiles(st_r) == []
    assert got.counters() == ref.counters()


def test_health_censoring_and_cadence_match_reference():
    import repro.faults.integrity as ref_mod

    import repro_torch.faults.integrity as port_mod

    assert port_mod.SAMPLE_PERIOD == ref_mod.SAMPLE_PERIOD
    for mode in ("off", "sample", "always"):
        assert [port_mod.should_verify(mode, t) for t in range(12)] == \
            [ref_mod.should_verify(mode, t) for t in range(12)]
    a = port_mod.WorkerHealth(graylist_after=2, probation=3)
    b = ref_mod.WorkerHealth(graylist_after=2, probation=3)
    rng = np.random.default_rng(7)
    for step in range(30):
        n = int(rng.integers(0, 4))
        if rng.random() < 0.4:
            assert a.strike(n, step) == b.strike(n, step)
        assert a.graylisted(step) == b.graylisted(step)
        assert a.strikes == b.strikes
    loads = {n: float(rng.uniform(10, 100)) for n in range(4)}
    durs = {n: float(rng.uniform(0.01, 1.0)) for n in range(4)}
    for q in ((), {1}, {0, 3}):
        assert port_mod.censor_measurements(loads, durs, q) == \
            ref_mod.censor_measurements(loads, durs, q)
    tile = rng.standard_normal((16, 32)).astype(np.float32)
    assert port_mod.tile_checksum(tile) == ref_mod.tile_checksum(tile)


# ---------------------------------------------------------------------- #
# The engine under corruption: port against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
@pytest.mark.parametrize("kind", ["tile_corruption", "result_corruption"])
def test_corruption_kind_matches_reference(reference, kind, grid,
                                           segmented):
    """Detected and repaired with no recovery: restaged (tile) or
    quarantined (result), bitwise the clean run, one executor entry; the
    clean run itself logs no sketch failure."""
    g = f"{grid[0]}{grid[1]}"
    got = run(f"{kind}_{g}", segmented)
    assert_matches(got, reference[f"{kind}_{g}"])
    clean = run(f"clean_{g}", segmented)
    assert_matches(clean, reference[f"clean_{g}"])
    assert_same_bits(got, clean)
    assert actions(got) == [ACTION[kind]]
    assert got["counts"].tolist() == [8, 0, 1]
    assert integrity(clean, "sketch_failures") == 0
    assert integrity(clean, "checks") > 0
    assert integrity(got, "sketch_failures") == (
        1 if kind == "result_corruption" else 0)


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", FULL_GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_result_corruption_full_arrival_fuse_grid(reference, grid,
                                                  segmented):
    g = f"{grid[0]}{grid[1]}"
    got = run(f"result_corruption_{g}", segmented)
    assert_matches(got, reference[f"result_corruption_{g}"])
    assert_same_bits(got, reference[f"clean_{g}"])
    assert actions(got) == ["quarantined"]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_uncovered_corruption_matches_reference(reference, grid,
                                                segmented):
    """S = 0: the barrier demotes the culprit and re-executes the step;
    the fused window repairs the rows from a replica tile instead (no
    demotion). Either way bitwise the clean S = 0 run."""
    g = f"{grid[0]}{grid[1]}"
    got = run(f"corrupt_s0_{g}", segmented)
    assert_matches(got, reference[f"corrupt_s0_{g}"])
    assert_same_bits(got, reference[f"clean_s0_{g}"])
    if grid == ("barrier", 1):
        assert actions(got) == ["demoted"]
        assert got["counts"].tolist() == [8, 1, 1]
        assert "3" not in got["rep_available"][-1]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_repeat_offender_graylisted(reference, grid, segmented):
    g = f"{grid[0]}{grid[1]}"
    got = run(f"graylist_{g}", segmented)
    assert_matches(got, reference[f"graylist_{g}"])
    assert_same_bits(got, reference[f"clean_{g}"])
    assert integrity(got, "quarantined") == 2
    assert integrity(got, "graylist_events") == 1


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_seeded_corruption_schedule(reference, grid, segmented):
    g = f"{grid[0]}{grid[1]}"
    got = run(f"seeded_{g}", segmented)
    assert_matches(got, reference[f"seeded_{g}"])
    assert_same_bits(got, reference[f"clean_{g}"])
    assert got["counts"][2] == 1


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_unverified_tile_corruption_reaches_the_kernel(reference, grid,
                                                       segmented):
    """A tile corrupted at a step that ``verify_results="sample"`` skips:
    the executor reads the corrupt bits, so the outputs leave the clean
    run's — bit for bit as the reference's do."""
    g = f"{grid[0]}{grid[1]}"
    got = run(f"unverified_{g}", segmented)
    assert_matches(got, reference[f"unverified_{g}"])
    assert got["eigvec"].tobytes() != reference[f"clean_{g}"]["eigvec"] \
        .tobytes()
    assert got["records"].tolist() == []


@pytest.mark.parametrize("segmented", MODES)
def test_noop_backup_and_silent_without_defense(reference, segmented):
    """Corrupting a worker that wins no rows is a noop; with
    verify_results off the same corruption goes undetected and the output
    is wrong (the threat the defense exists for)."""
    got = run("noop_barrier1", segmented)
    assert_matches(got, reference["noop_barrier1"])
    assert actions(got) == ["noop"]
    assert_same_bits(got, reference["clean_barrier1"])
    silent = run("silent_barrier1", segmented)
    assert_matches(silent, reference["silent_barrier1"])
    assert silent["eigvec"].tobytes() != \
        reference["clean_barrier1"]["eigvec"].tobytes()


@pytest.mark.parametrize("segmented", MODES)
def test_quarantine_redispatch_stays_out_of_wall_s(segmented):
    """The barrier's integrity re-dispatch is recovery, not the step: the
    fault step's ``StepReport.wall_s`` leaves it out, as the reference's
    does. The re-dispatch is made to sleep 0.2 s; the step's wall stays
    below that."""
    import time

    from test_torch_faults import engine, schedule
    from repro_torch.runtime import make_exact_matrix

    eng = engine("repro_torch", segmented=segmented, device="cpu", **ALWAYS)
    runner = eng._runner = eng._build_runner(make_exact_matrix(384, 0))
    executor = runner._executor

    def slow(staged, plan, w, include=None):
        if include is not None:  # only the quarantine's re-dispatch masks
            time.sleep(0.2)
        return executor(staged, plan, w, include)

    runner._executor = slow
    res = eng.run(n_steps=5, faults=schedule(
        "repro_torch", [("result_corruption", 3, 3)]))
    assert [r.action for r in res.fault_records] == ["quarantined"]
    assert res.reports[3].straggled == (3,)
    assert res.reports[3].wall_s < 0.2
