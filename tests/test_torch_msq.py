"""Port parity for MSQ (msq/{memmodel,err_tables,solver,latmodel}.py, the
solve_* CLIs and fit_latency_coeffs) against the JAX reference's, on the
CPU.

The latency-constrained solver reproduces the committed 215.0thp_cc
qdict and merge info from the committed v5e table and error tables, and
equals the reference's solver with no_fuse, without use_cc and on the
Lagrangian path (exact=False), those at fewer layers to keep the MILP and
the bisection short; the memory-constrained one equals the reference's
at 3.25 bits (the committed 3.25bit.json is not the reference's own
output today, so it is not the yardstick).  The committed H100 table has
the solver's schema, and the committed H100 qdict is its solution."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest

from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.msq import latmodel as jlat
from qpalette_tpu.msq import memmodel as jmem
from qpalette_tpu.msq import solver as jsol

from qpalette_tpu_torch import fit_latency_coeffs, solve_lat_const
from qpalette_tpu_torch import solve_mem_const
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq import latmodel, memmodel, solver
from qpalette_tpu_torch.msq.err_tables import (build_err_table,
                                               uniform_err_coeffs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained", "v5e",
                   "default_err")
H100 = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained", "h100",
                    "default_err")
MEM = os.path.join(ROOT, "msq_results", "3_8b", "mem_constrained",
                   "default", "3.25bit.json")
CFG, JCFG = LlamaConfig.llama31_8b(), JConfig.llama31_8b()


def _load(path):
    with open(path) as f:
        return json.load(f)


def _coeffs():
    return {k: v for k, v in _load(os.path.join(
        ROOT, "assets", "3_8b_err_coeffs.json")).items()
        if not k.startswith("__")}


LAT = _load(os.path.join(ROOT, "assets", "3_8b_latency_coeffs_v5e.json"))
ERRS = build_err_table(list(solver.QDICT_LAT))


def _scaled_thp(thp, layers):
    """The target that leaves `layers` layers the share of the
    projection budget that thp leaves 32."""
    c = LAT["constant"]
    return 1.0 / ((1.0 / thp - c) * layers / 32 + c)


def test_lat_solver_reproduces_committed():
    sol = solver.solve_lat_constrained(CFG, list(solver.QDICT_LAT), ERRS,
                                       LAT, 215.0, err_coeffs=_coeffs(),
                                       use_impl_choice=True)
    assert {k: list(v) for k, v in sol.qdict.items()} == _load(
        os.path.join(V5E, "215.0thp_cc.json"))
    assert sol.merge_info == _load(os.path.join(
        V5E, "215.0thp_cc_merge_info.json"))
    assert sol.est_latency == pytest.approx(latmodel.qdict_latency(
        LAT, sol.qdict, sol.merge_info, 32), rel=1e-12)


@pytest.mark.parametrize("layers,thp,kw", [
    (32, 215.0, dict()),                                   # without use_cc
    (4, 195.0, dict(use_impl_choice=True, no_fuse=True)),
    (2, 215.0, dict(use_impl_choice=True, exact=False)),   # Lagrangian
], ids=["no_cc", "no_fuse", "lagrangian"])
def test_lat_solver_matches_reference(layers, thp, kw):
    target = _scaled_thp(thp, layers)
    got, want = (mod.solve_lat_constrained(
        cfg, list(mod.QDICT_LAT), ERRS, LAT, target, err_coeffs=_coeffs(),
        num_layers=layers, **kw)
        for mod, cfg in ((solver, CFG), (jsol, JCFG)))
    assert got.qdict == want.qdict and got.merge_info == want.merge_info
    assert (got.est_latency, got.est_err) == (want.est_latency,
                                              want.est_err)
    if kw.get("no_fuse"):
        assert all(not m for m in got.merge_info)


def test_mem_solver_matches_reference():
    errs = build_err_table(list(solver.QDICT_MEM))
    got = solver.solve_mem_constrained(CFG, list(solver.QDICT_MEM), errs,
                                       3.25, err_coeffs=_coeffs())
    want = jsol.solve_mem_constrained(JCFG, list(jsol.QDICT_MEM), errs,
                                      3.25, err_coeffs=_coeffs())
    assert got == want
    assert memmodel.calc_avg_bits(CFG, got) <= 3.25
    assert (solver.QDICT_MEM, solver.QDICT_LAT, solver.MERGE_GROUPS,
            solver.ATTN_PARTITIONS, solver.MLP_PARTITIONS) == (
        jsol.QDICT_MEM, jsol.QDICT_LAT, jsol.MERGE_GROUPS,
        jsol.ATTN_PARTITIONS, jsol.MLP_PARTITIONS)


def test_models_match_reference():
    """memmodel and latmodel against the reference's on the committed
    qdicts and on every group x quantizer of the latency palette."""
    qdicts = [_load(MEM)] + [_load(p) for p in sorted(glob.glob(
        os.path.join(V5E, "*thp_cc.json")))]
    for qd in qdicts:
        assert memmodel.calc_avg_bits(CFG, qd) == jmem.calc_avg_bits(JCFG,
                                                                     qd)
    assert memmodel.constant_mem_bytes(CFG) == jmem.constant_mem_bytes(JCFG)
    for key in memmodel.LAYER_KEYS:
        assert memmodel.layer_shape(CFG, key) == tuple(jmem.layer_shape(
            JCFG, key))
    for q in solver.QDICT_LAT:
        assert latmodel.family_of(q) == jlat.family_of(q)
        for g in latmodel.GROUPS:
            assert latmodel.packed_bytes(CFG, g, q) == jlat.packed_bytes(
                JCFG, g, q)
            assert latmodel.kernel_calls(g, q) == jlat.kernel_calls(g, q)
    rng = np.random.default_rng(0)
    samples = [(latmodel.family_of(q), latmodel.packed_bytes(CFG, g, q),
                float(rng.uniform(5e-6, 5e-5)))
               for g in ("q", "ug") for q in ("tcq2s_6_none_0.9",
                                              "tcq2s_8_none_0.9",
                                              "tcq_6_none_0.9",
                                              "ldlq_2_6_none_1.0")]
    fams = latmodel.fit_family_model(samples)
    assert fams == jlat.fit_family_model(samples)
    assert latmodel.build_lat_table(CFG, list(solver.QDICT_LAT), fams,
                                    2e-3) == jlat.build_lat_table(
        JCFG, list(jsol.QDICT_LAT), fams, 2e-3)
    assert uniform_err_coeffs(2) == {f"{i}_{k}": 1.0 for i in range(2)
                                     for k in memmodel.LAYER_KEYS}


def test_missing_err_entry_names_item_7(tmp_path, monkeypatch):
    """A scheme missing from the table is measured (here on a 64x64
    matrix, on the CPU: the reference's quantizer_proxy_err of the same
    matrix) and written to the table under $QPALETTE_ASSETS; the committed
    entries are read as they are."""
    from qpalette_tpu.msq.err_tables import quantizer_proxy_err as jproxy
    monkeypatch.setenv("QPALETTE_ASSETS", str(tmp_path))
    table = build_err_table(["tcq_6_none_0.9", "ldlq_2_6_none_0.9"],
                            size=64, verbose=False, device="cpu")
    with open(os.path.join(ROOT, "assets", "quant_err.json")) as f:
        committed = json.load(f)
    assert "ldlq_2_6_none_0.9" not in committed
    assert table["tcq_6_none_0.9"] == committed["tcq_6_none_0.9"]
    want = jproxy("ldlq_2_6_none_0.9", size=64)
    assert abs(table["ldlq_2_6_none_0.9"] - want) <= 1e-3 * want
    with open(tmp_path / "quant_err.json") as f:
        assert json.load(f) == table
    assert len(table) == len(committed) + 1


def _reference_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_clis_write_the_reference_files(tmp_path, monkeypatch):
    """Both CLIs, run as the reference's are (relative paths under the
    working directory), write the reference CLIs' files byte for byte."""
    for side in ("ref", "port"):
        d = tmp_path / side
        (d / "assets").mkdir(parents=True)
        for name in ("3_8b_latency_coeffs_v5e.json", "3_8b_err_coeffs.json"):
            (d / "assets" / name).write_bytes(
                open(os.path.join(ROOT, "assets", name), "rb").read())
        monkeypatch.chdir(d)
        lat_args = ["--target_thp", "215", "--nodename", "v5e", "--use_cc"]
        mem_args = ["--target_bitwidth", "3.25"]
        if side == "ref":
            for name, args in (("solve_lat_const", lat_args),
                               ("solve_mem_const", mem_args)):
                monkeypatch.setattr("sys.argv", [name] + args)
                _reference_cli(name).main()
        else:
            solve_lat_const.main(lat_args)
            solve_mem_const.main(mem_args)
    files = sorted(str(p.relative_to(tmp_path / "ref"))
                   for p in (tmp_path / "ref" / "msq_results").rglob("*.json"))
    assert files == [
        "msq_results/3_8b/lat_constrained/v5e/default_err/215.0thp_cc.json",
        "msq_results/3_8b/lat_constrained/v5e/default_err/"
        "215.0thp_cc_merge_info.json",
        "msq_results/3_8b/mem_constrained/default/3.25bit.json"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes()
    assert (tmp_path / "port" / files[0]).read_bytes() == open(
        os.path.join(V5E, "215.0thp_cc.json"), "rb").read()


def _schema_keys():
    return {f"{g}_{q}_{fl}" for g in latmodel.GROUPS
            for q in solver.QDICT_LAT for fl in ("False", "True")}


def test_fit_rehearsal_cpu(tmp_path, monkeypatch):
    """fit_latency_coeffs on the CPU over 1 group x 2 quantizers: the
    table has build_lat_table's schema, measured entries replace the fit
    (the ldlq one's `_True` key by the dequant route), and it is labelled
    a rehearsal."""
    monkeypatch.setenv("QPT_FIT_GROUPS", "o")
    monkeypatch.setenv("QPT_FIT_QS", "tcq2s_6_none_0.9,ldlq_2_6_none_1.0")
    out = tmp_path / "table.json"
    table = fit_latency_coeffs.main(["--device", "cpu", "--constant", "1e-3",
                                     "--reps", "1", "--out", str(out)])
    assert _load(out) == table
    assert _schema_keys() | {"constant"} <= set(table)
    assert table["constant"] == 1e-3
    assert table["__device__"].startswith("cpu")
    assert table["__source__"] == "measured-sample-fit"
    assert all(table[k] > 0 for k in _schema_keys())
    assert table["o_ldlq_2_6_none_1.0_True"] != \
        table["o_ldlq_2_6_none_1.0_False"]


def _h100():
    return _load(os.path.join(ROOT, "assets",
                              "3_8b_latency_coeffs_h100.json"))


def test_committed_h100_table():
    """The table measured on the card: every key of the solver's schema,
    every entry and the constant positive, the card named."""
    table = _h100()
    assert _schema_keys() <= set(table)
    assert all(table[k] > 0 for k in _schema_keys() | {"constant"})
    assert table["__nodename__"] == "h100" and table["__impl__"] == "a8"
    assert table["__source__"] == "measured"
    assert "H100" in table["__device__"] and " W" in table["__device__"]


def test_committed_h100_qdict_is_the_solution():
    """The committed H100 qdict and merge info are what the solver gives
    from the committed H100 table at their target, and the table puts
    them at or under its latency."""
    (path,) = glob.glob(os.path.join(H100, "*thp_cc.json"))
    target = float(os.path.basename(path).split("thp")[0])
    table = _h100()
    sol = solver.solve_lat_constrained(CFG, list(solver.QDICT_LAT), ERRS,
                                       table, target, err_coeffs=_coeffs(),
                                       use_impl_choice=True)
    assert {k: list(v) for k, v in sol.qdict.items()} == _load(path)
    assert sol.merge_info == _load(path.replace(".json",
                                                "_merge_info.json"))
    assert latmodel.qdict_latency(table, sol.qdict, sol.merge_info,
                                  32) <= 1.0 / target
