"""The paper's STG path in the port against the JAX package, on the CPU.

The port's copies of the intra-node optimizer (`core.intra_node`), the
replication transforms (`core.transform`), the KPN simulator
(`core.simulate`) and the paper's graphs (`graphs.jpeg`, `graphs.nbody`,
`graphs.streamit`) are plain Python and numpy, so the JAX package is the
oracle bit for bit:

  * `enumerate_impls` and `schedule_for_target` give equal frontiers,
    expansions and clusters;
  * `simulate.run` gives bitwise-equal sink streams and identical firing
    times, firing counts and cycle counts, on the graphs as built and on
    their materialised (replicated) forms;
  * the ILP and the heuristic choose the same selections at the same
    areas on the JPEG graph (the paper's Tables 1-2);

and each case of ``tests/test_intra_node.py``, ``test_simulator.py`` and
``test_jpeg_repro.py`` runs on the port as it runs there.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.fork_join as j_fork_join
import repro.core.heuristic as j_heuristic
import repro.core.ilp as j_ilp
import repro.core.intra_node as j_intra_node
import repro.core.simulate as j_simulate
import repro.core.stg as j_stg
import repro.core.throughput as j_throughput
import repro.core.transform as j_transform
import repro.graphs.jpeg as j_jpeg
import repro.graphs.nbody as j_nbody
import repro.graphs.streamit as j_streamit
from repro_torch.core import (fork_join, heuristic, ilp, intra_node, simulate, stg,
                              throughput, transform)
from repro_torch.graphs import jpeg, nbody, streamit

JAX = SimpleNamespace(stg=j_stg, fj=j_fork_join, heuristic=j_heuristic, ilp=j_ilp,
                      intra_node=j_intra_node, simulate=j_simulate,
                      throughput=j_throughput, transform=j_transform, jpeg=j_jpeg,
                      nbody=j_nbody, streamit=j_streamit)
PORT = SimpleNamespace(stg=stg, fj=fork_join, heuristic=heuristic, ilp=ilp,
                       intra_node=intra_node, simulate=simulate, throughput=throughput,
                       transform=transform, jpeg=jpeg, nbody=nbody, streamit=streamit)


def same(a, b) -> bool:
    """Bitwise equality of tokens: numpy arrays by dtype, shape and bytes,
    sequences element by element, anything else by ``==``."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def impls_of(impls) -> list:
    return [dataclasses.asdict(im) for im in impls]


def sim_record(res) -> dict:
    return dict(fire_times=res.fire_times, fired=res.fired, cycles=res.cycles)


def assert_same_run(got, want):
    """Two `SimResult`s (or `PipelineRun`s): bitwise-equal sink streams,
    identical firing times, firing counts and cycles."""
    assert set(got.outputs) == set(want.outputs)
    for k in want.outputs:
        assert same(got.outputs[k], want.outputs[k]), k
    assert sim_record(got) == sim_record(want)


def both(fn):
    """``fn`` on the JAX package and on the port: (jax's, port's)."""
    return fn(JAX), fn(PORT)


# ===========================================================================
# intra-node optimizer (tests/test_intra_node.py)
# ===========================================================================
def test_nbody_sum_ii_is_33():
    assert both(lambda P: P.nbody.FORCE_BODY.total_ii()) == (33, 33)


@pytest.mark.parametrize("target", [8.0, 1.0, 3.0, 33.0])
def test_schedule_for_target_matches_jax(target):
    want, got = both(lambda P: P.intra_node.schedule_for_target(P.nbody.FORCE_BODY, target))
    assert dataclasses.asdict(got.impl) == dataclasses.asdict(want.impl)
    assert got.expansions == want.expansions
    assert got.clusters == want.clusters


def test_nbody_naive_pipeline_stalls_at_div():
    s = intra_node.schedule_for_target(nbody.FORCE_BODY, 8.0)
    assert s.impl.ii == 8.0
    assert not s.expansions


def test_nbody_expansion_reaches_ii1():
    s = intra_node.schedule_for_target(nbody.FORCE_BODY, 1.0)
    assert s.impl.ii == 1.0
    assert s.expansions["f"] == 8 and s.expansions["r"] == 8
    assert s.impl.area == nbody.FORCE_BODY.total_ii()


def test_nbody_frontier_spans_1_to_33_as_jax():
    want, got = both(lambda P: P.nbody.force_impls())
    assert impls_of(got) == impls_of(want)
    iis = [im.ii for im in got]
    assert min(iis) == 1 and max(iis) == 33
    by_ii = {im.ii: im for im in got}
    assert by_ii[33].area == 1 and by_ii[1].area == 33
    for a, b in zip(got, got[1:]):
        assert a.ii < b.ii and a.area > b.area


def test_replication_equivalence_claim():
    by_ii = {im.ii: im for im in nbody.force_impls()}
    assert by_ii[33].area * 33 == by_ii[1].area * 1


def _body(P, kinds, chain):
    ops = tuple(P.intra_node.PrimOp(f"o{i}", k, deps=(f"o{i-1}",) if chain and i else ())
                for i, k in enumerate(kinds))
    return P.intra_node.CompositeBody(ops=ops)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.sampled_from(["add", "mul", "div", "sqrt", "sub"]), min_size=1, max_size=12),
       st.integers(min_value=1, max_value=40))
def test_schedule_meets_target_and_area_sane(kinds, target):
    want, got = both(lambda P: P.intra_node.schedule_for_target(_body(P, kinds, True),
                                                                float(target)))
    body = _body(PORT, kinds, True)
    assert got.impl.ii <= target + 1e-9
    assert 1 <= got.impl.area <= body.total_ii()
    assert sorted(n for c in got.clusters for n in c) == sorted(o.name for o in body.ops)
    assert (dataclasses.asdict(got.impl), got.expansions, got.clusters) == \
        (dataclasses.asdict(want.impl), want.expansions, want.clusters)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(["add", "mul", "div"]), min_size=1, max_size=10))
def test_frontier_pareto_and_equal_to_jax(kinds):
    want, got = both(lambda P: P.intra_node.enumerate_impls(_body(P, kinds, False)))
    assert impls_of(got) == impls_of(want)
    for a, b in zip(got, got[1:]):
        assert a.ii < b.ii and a.area > b.area


@pytest.mark.parametrize("build", ["fft", "filterbank", "autocor"])
def test_streamit_implementation_libraries_equal_jax(build):
    want, got = both(lambda P: getattr(P.streamit, f"build_{build}")())
    assert list(got.nodes) == list(want.nodes)
    for name in want.nodes:
        assert impls_of(got.nodes[name].impls) == impls_of(want.nodes[name].impls), name
    rich = [n for n, node in got.nodes.items() if node.kind == "compute" and len(node.impls) >= 3]
    assert rich


# ===========================================================================
# KPN simulator and transforms (tests/test_simulator.py)
# ===========================================================================
def _id_chain(P, iis):
    g = P.stg.STG()
    g.add_node(P.stg.Node("src", impls=(P.stg.Impl("s", 0, 1e-9),), kind="source"))
    prev = "src"
    for k, ii in enumerate(iis):
        g.add_node(P.stg.unit_rate_node(f"n{k}", [P.stg.Impl("v1", 1, ii)],
                                        fn=lambda inputs, state: ([[inputs[0][0] + 1]], state)))
        g.connect(prev, f"n{k}")
        prev = f"n{k}"
    g.add_node(P.stg.Node("out", impls=(P.stg.Impl("t", 0, 1e-9),), kind="sink"))
    g.connect(prev, "out")
    g.validate()
    return g


def test_functional_chain():
    want, got = both(lambda P: P.simulate.run_functional(
        _id_chain(P, [1, 1, 1]), P.stg.Selection.fastest(_id_chain(P, [1, 1, 1])),
        {"src": list(range(10))}))
    assert got["out"] == [x + 3 for x in range(10)] == want["out"]


def test_timed_throughput_matches_analysis_and_jax():
    def go(P):
        g = _id_chain(P, [2, 7, 3])
        sel = P.stg.Selection.fastest(g)
        return P.simulate.run(g, sel, {"src": list(range(200))}), P.throughput.analyze(g, sel)
    (want, _), (got, ana) = both(go)
    assert_same_run(got, want)
    assert math.isclose(got.inverse_throughput("out"), ana.v_app, rel_tol=0.05)


def _replicated(P, iis, reps, fj):
    g = _id_chain(P, iis)
    sel = P.stg.Selection.fastest(g)
    for name, nr in reps.items():
        sel.set(name, "v1", nr)
    return g, P.transform.materialize(g, sel, fj(P))


def test_timed_throughput_with_replication():
    def go(P):
        _, rep = _replicated(P, [1, 8, 1], {"n1": 8}, lambda P: P.fj.LITERAL)
        return P.simulate.run(rep.stg, rep.selection, {"src": list(range(400))}), rep
    (want, j_rep), (got, rep) = both(go)
    assert_same_run(got, want)
    assert sorted(rep.stg.nodes) == sorted(j_rep.stg.nodes)
    assert rep.replica_map == j_rep.replica_map
    assert rep.overhead_area() == j_rep.overhead_area()
    assert got.inverse_throughput("out") < 8 * 0.5


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(1, 8), min_size=1, max_size=4),
       st.sampled_from([1, 2, 4, 8, 16]), st.sampled_from([2, 3, 4]))
def test_replication_preserves_streams(iis, nr, nf):
    def go(P):
        g, rep = _replicated(P, iis, {f"n{len(iis) // 2}": nr},
                             lambda P: P.fj.ForkJoinModel(nf=nf))
        inputs = {"src": list(range(64))}
        plain = P.simulate.run_functional(g, P.stg.Selection.fastest(g), inputs)["out"]
        return plain, P.simulate.run(rep.stg, rep.selection, inputs)
    (_, want), (plain, got) = both(go)
    assert got.outputs["out"] == plain
    assert_same_run(got, want)


@pytest.mark.parametrize("iis,reps,nf", [([4, 8], {"n0": 4, "n1": 8}, 2),
                                         ([8, 2, 8], {"n0": 8, "n1": 2, "n2": 8}, 4)])
def test_double_replication_and_join_then_fork(iis, reps, nf):
    def go(P):
        g, rep = _replicated(P, iis, reps, lambda P: P.fj.ForkJoinModel(nf=nf))
        inputs = {"src": list(range(128))}
        plain = P.simulate.run_functional(g, P.stg.Selection.fastest(g), inputs)["out"]
        return plain, P.simulate.run(rep.stg, rep.selection, inputs)
    (_, want), (plain, got) = both(go)
    assert got.outputs["out"] == plain
    assert_same_run(got, want)


def test_jpeg_functional_reference():
    def go(P):
        g = P.jpeg.build_stg()
        blocks = P.jpeg.random_blocks(12)
        return P.simulate.run(g, P.stg.Selection.fastest(g), {"camera": blocks}), \
            P.jpeg.reference_pipeline(blocks)
    (want, j_ref), (got, ref) = both(go)
    assert same(got.outputs["bitstream"], ref) and same(ref, j_ref)
    assert_same_run(got, want)


@pytest.mark.parametrize("v", [1, 4])
def test_jpeg_heuristic_solution_is_stream_equivalent(v):
    def go(P):
        g = P.jpeg.build_stg()
        res = P.heuristic.min_area(g, v, P.fj.JPEG_CALIBRATED)
        rep = P.transform.materialize(g, res.selection, P.fj.JPEG_CALIBRATED)
        blocks = P.jpeg.random_blocks(48)
        return res.selection.choices, P.simulate.run(
            rep.stg, rep.selection, {"camera": blocks}), P.jpeg.reference_pipeline(blocks)
    (j_sel, want, _), (sel, got, ref) = both(go)
    assert sel == j_sel
    assert same(got.outputs["bitstream"], ref)
    assert_same_run(got, want)


def test_nbody_functional():
    def go(P):
        g = P.nbody.build_stg()
        pairs = P.nbody.random_pairs(16)
        return P.simulate.run(g, P.stg.Selection.fastest(g), {"pairs": pairs}), pairs
    (want, _), (got, pairs) = both(go)
    for acc, pair in zip(got.outputs["acc"], pairs):
        np.testing.assert_allclose(acc, nbody.force_fn(pair), rtol=1e-12)
    assert_same_run(got, want)


def test_nbody_replicated_33x_reaches_ii1():
    g = nbody.build_stg()
    slowest = max(g.nodes["force"].impls, key=lambda im: im.ii)
    assert slowest.ii == 33
    a = throughput.analyze(g, stg.Selection.fastest(g).set("force", slowest.name, 33))
    assert a.node_iter_time["force"] == 1.0


@pytest.mark.parametrize("build,n_in,seed,ref", [
    ("fft", 8, 3, lambda g, b: streamit.fft_reference(b)),
    ("filterbank", 32, 4, streamit.filterbank_reference),
    ("autocor", 16, 5, lambda g, b: streamit.autocor_reference(b))])
def test_streamit_functional(build, n_in, seed, ref):
    def go(P):
        g = getattr(P.streamit, f"build_{build}")()
        rng = np.random.default_rng(seed)
        blocks = [rng.normal(size=n_in) + (1j * rng.normal(size=n_in) if build == "fft" else 0)
                  for _ in range(6)]
        return g, blocks, P.simulate.run(g, P.stg.Selection.fastest(g), {"src": blocks})
    (_, _, want), (g, blocks, got) = both(go)
    for a, b in zip(got.outputs["out"], ref(g, blocks)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert_same_run(got, want)


# ===========================================================================
# the paper's JPEG tables (tests/test_jpeg_repro.py)
# ===========================================================================
def _tradeoff(res) -> tuple:
    return (res.feasible, res.selection.choices, res.total_area, res.overhead_area, res.v_app)


@pytest.mark.parametrize("v", [1, 2, 4, 8])
def test_jpeg_solvers_equal_jax(v):
    want, got = both(lambda P: [_tradeoff(s(P.jpeg.build_stg(), v, P.fj.JPEG_CALIBRATED))
                                for s in (P.ilp.min_area, P.heuristic.min_area)])
    assert got == want


@pytest.mark.parametrize("v,rel", [(1, 0.01), (4, 0.01)])
def test_ilp_totals_match_published(v, rel):
    res = ilp.min_area(jpeg.build_stg(), v, fork_join.JPEG_CALIBRATED)
    pub = jpeg.TABLE2_TOTALS[v][0]
    assert res.feasible and abs(res.total_area - pub) / pub < rel


@pytest.mark.parametrize("v", [1, 2, 4, 8])
def test_ilp_selects_single_copies_plus_encoder_replicas(v):
    g = jpeg.build_stg()
    res = ilp.min_area(g, v, fork_join.JPEG_CALIBRATED)
    assert res.selection.choices["encode"] == ("v1", 512 // v)
    for mod in ("color", "dct", "quant"):
        impl, nr = res.selection.choices[mod]
        assert nr == 1 and g.nodes[mod].impl(impl).ii <= v


@pytest.mark.parametrize("v", [1, 2, 4, 8])
def test_heuristic_beats_ilp_and_published(v):
    g = jpeg.build_stg()
    ri = ilp.min_area(g, v, fork_join.JPEG_CALIBRATED)
    rh = heuristic.min_area(g, v, fork_join.JPEG_CALIBRATED)
    assert rh.feasible and ri.feasible
    assert rh.total_area <= ri.total_area * 0.80
    assert rh.total_area <= jpeg.TABLE2_TOTALS[v][0] * 0.74
    assert rh.total_area <= jpeg.TABLE2_TOTALS[v][1] + 1e-6
    for res in (ri, rh):
        assert throughput.analyze(g, res.selection).v_app <= v + 1e-9


def test_heuristic_v8_exactly_published():
    rh = heuristic.min_area(jpeg.build_stg(), 8, fork_join.JPEG_CALIBRATED)
    assert rh.total_area == 1736 and rh.overhead_area == 0


def test_area_mode_inverts_throughput_mode():
    g = jpeg.build_stg()
    for v in (1, 2, 4, 8):
        for solver in (heuristic, ilp):
            res = solver.min_area(g, v, fork_join.JPEG_CALIBRATED)
            back = solver.max_throughput(g, res.total_area, fork_join.JPEG_CALIBRATED)
            assert back.feasible and back.v_app <= v + 1e-9
            j_back = getattr(JAX, solver.__name__.rsplit(".", 1)[1]).max_throughput(
                j_jpeg.build_stg(), res.total_area, j_fork_join.JPEG_CALIBRATED)
            assert _tradeoff(back) == _tradeoff(j_back)
