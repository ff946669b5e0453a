"""The port's static analysis (``repro_torch.analysis``): each pass agrees
with the JAX package's on the reference's own fixtures, each of the
port's rules trips on a fixture and goes quiet when disabled, the probes
and the FSM spec cover what they must, the real tree is clean modulo the
justified allowlist, and the engine's page walks keep the paged kernels'
promise on a CPU serve.

The JAX package's passes are imported inside the tests that compare with
them, so the ``gpu`` test at the end collects on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_analysis.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (allowlist, fsm_check, kernel_check,
                                  page_ledger, trace_lint)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.fsm_spec import FsmSpec
from repro_torch.analysis.kernel_check import PAGES, Array, Walk
from repro_torch.analysis.report import AllowEntry, Finding, apply_allowlist

TESTS = Path(__file__).parent
REF_FIX = TESTS / "fixtures" / "analysis"
FIX = TESTS / "fixtures" / "analysis_torch"
BAD_TREE = FIX / "bad_tree"
SRC = TESTS.parents[0] / "src" / "repro_torch"
REF_SRC = TESTS.parents[0] / "src" / "repro"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rules(findings):
    return {f.rule for f in findings}


def _keys(findings):
    return {(f.rule, f.line, f.symbol) for f in findings}


# ------------------------------------------------- parity with reference
_MINI = dict(
    states=("queued", "running", "escalated", "done"),
    initial="queued",
    terminal=("done",),
    edges=(("queued", "running"), ("running", "escalated"),
           ("escalated", "done"), ("running", "done")),
    assignment_sites={
        ("bad_fsm", "MiniSched.admit"): (("queued", "running"),),
        ("bad_fsm", "MiniSched.demote"): (("running", "escalated"),),
        ("bad_fsm", "MiniSched.flee"): (("escalated", "done"),),
        ("bad_fsm", "MiniSched.retire"): (("running", "done"),),
    },
    initial_sites=(("bad_fsm", "Request"),),
    reason_sites=(("bad_fsm", "MiniSched.retire"),),
    finish_reasons=("eos",),
    states_by_name={"QUEUED": "queued", "RUNNING": "running",
                    "ESCALATED": "escalated", "DONE": "done"},
)
# the reference's mini spec (tests/test_static_analysis.py), and variants
# that trip the rules its fixture leaves quiet
SPECS = {
    "mini": _MINI,
    "orphan_state": {**_MINI, "states": _MINI["states"] + ("limbo",)},
    "stale_site": {**_MINI, "assignment_sites": {
        **_MINI["assignment_sites"],
        ("bad_fsm", "MiniSched.vanished"): (("running", "done"),)}},
    "edge_not_in_table": {**_MINI, "assignment_sites": {
        **_MINI["assignment_sites"],
        ("bad_fsm", "MiniSched.admit"): (("queued", "running"),
                                         ("queued", "done"))}},
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_fsm_check_matches_reference_on_its_fixture(spec):
    from repro.analysis import fsm_check as ref_fsm
    from repro.analysis.fsm_spec import FsmSpec as RefSpec
    files = {"bad_fsm": REF_FIX / "bad_fsm.py"}
    got = fsm_check.check(files, spec=FsmSpec(**SPECS[spec]))
    want = ref_fsm.check(files, spec=RefSpec(**SPECS[spec]))
    assert got and _keys(got) == _keys(want)


def test_fsm_check_matches_reference_on_its_serving_tree():
    """The reference's own engine under its own spec: both checkers
    report nothing, and the port's finds the spec's site where the
    reference's engine moved nothing."""
    from repro.analysis import fsm_check as ref_fsm
    from repro.analysis.fsm_spec import default_spec as ref_default
    ref_spec = ref_default()
    port_spec = FsmSpec(**dataclasses.asdict(ref_spec))
    assert _keys(fsm_check.run(REF_SRC, spec=port_spec)) == \
        _keys(ref_fsm.run(REF_SRC, spec=ref_spec)) == set()
    # the reference's spec on the port's engine: the one moved write
    moved = _keys(fsm_check.run(SRC, spec=port_spec))
    assert moved == {
        ("fsm-undeclared-site", 962, "ContinuousEngine._prefill_one_shot"),
        ("fsm-stale-spec", 0, "ContinuousEngine._admit")}


@pytest.mark.parametrize("tree", ["fixture", "reference", "port"])
def test_page_ledger_matches_reference(tree):
    from repro.analysis import page_ledger as ref_ledger
    if tree == "fixture":
        path = REF_FIX / "rogue_free.py"
        got = page_ledger.check_file(path, "rogue_free.py")
        want = ref_ledger.check_file(path, "rogue_free.py")
        assert got
    else:
        root = REF_SRC if tree == "reference" else SRC
        got, want = page_ledger.run(root), ref_ledger.run(root)
        assert {f.symbol for f in got} == {"PagedKVCache.hold_pages",
                                           "PagedKVCache.release_pages"}
    assert _keys(got) == _keys(want)


@pytest.mark.parametrize("rule", ["wall-clock", "mutable-default"])
def test_trace_lint_matches_reference_on_its_fixture(rule):
    from repro.analysis import trace_lint as ref_trace
    got = [f for f in trace_lint.run(REF_FIX / "bad_trace") if f.rule == rule]
    want = [f for f in ref_trace.run(REF_FIX / "bad_trace")
            if f.rule == rule]
    assert got and _keys(got) == _keys(want)
    for root in (REF_SRC, SRC):    # both trees are clean of both rules
        assert not [f for f in trace_lint.run(root) if f.rule == rule]


def test_apply_allowlist_matches_reference():
    from repro.analysis import report as ref_report
    rows = [("r", "a/b.py", 1, "S", "m"), ("r", "a/c.py", 2, "T", "m"),
            ("q", "a/b.py", 3, "S", "m")]
    entries = [("r", "b.py", "S", "because"), ("r", "zzz.py", "", "old"),
               ("q", "b.py", "", "  "), ("r", "c.py", "U", "other symbol")]
    outs = []
    for mod in (ref_report, None):
        F = ref_report.Finding if mod else Finding
        A = ref_report.AllowEntry if mod else AllowEntry
        apply = ref_report.apply_allowlist if mod else apply_allowlist
        rep, sup, problems = apply([F(*r) for r in rows],
                                   [A(*e) for e in entries])
        outs.append(([dataclasses.astuple(f) for f in rep],
                     [dataclasses.astuple(f) for f in sup], problems))
    assert outs[0] == outs[1]
    assert outs[1][2], "the fixture's stale and reasonless entries"


# -------------------------------------------------------------- trip: fsm
def _fsm_trip(rule):
    """(files, spec) on which ``rule`` fires."""
    spec = {"fsm-stale-spec": "stale_site",
            "fsm-undeclared-edge": "edge_not_in_table",
            "fsm-graph": "orphan_state"}.get(rule, "mini")
    return {"bad_fsm": REF_FIX / "bad_fsm.py"}, FsmSpec(**SPECS[spec])


@pytest.mark.parametrize("rule", sorted(fsm_check.RULES))
def test_fsm_rule_trips_and_goes_quiet(rule):
    files, spec = _fsm_trip(rule)
    assert rule in _rules(fsm_check.check(files, spec=spec))
    off = fsm_check.check(files, spec=spec, rules=fsm_check.RULES - {rule})
    assert rule not in _rules(off)


# ----------------------------------------------------------- trip: ledger
@pytest.mark.parametrize("rule", sorted(page_ledger.RULES))
def test_ledger_rule_trips_and_goes_quiet(rule):
    path = REF_FIX / "rogue_free.py"
    assert rule in _rules(page_ledger.check_file(path, "rogue_free.py"))
    off = page_ledger.check_file(path, "rogue_free.py",
                                 rules=page_ledger.RULES - {rule})
    assert rule not in _rules(off)


# ------------------------------------------------------------ trip: trace
HOT = FIX / "bad_hot"


def test_trace_lint_flags_every_host_sync_form():
    found = trace_lint.run(HOT)
    sync = {f.line for f in found if f.rule == "host-sync"}
    # .item .tolist .cpu .numpy .to("cpu") synchronize, if, while, int(),
    # bool(); not the module-level .cpu()
    assert sync == {11, 12, 13, 14, 15, 16, 17, 19, 21, 22}, sorted(sync)
    assert {(f.rule, f.line) for f in found if f.rule != "host-sync"} == \
        {("wall-clock", 27), ("mutable-default", 30)}
    # outside serving/ and models/ a read-back is no finding, nor a
    # wall-clock stamp outside a serving path
    path = HOT / "serving" / "hot_step.py"
    assert _rules(trace_lint.check_file(path, "core/hot_step.py")) == \
        {"mutable-default"}


@pytest.mark.parametrize("rule", sorted(trace_lint.RULES))
def test_trace_rule_trips_and_goes_quiet(rule):
    assert rule in _rules(trace_lint.run(HOT))
    assert rule not in _rules(trace_lint.run(
        HOT, rules=trace_lint.RULES - {rule}))


# ----------------------------------------------------------- trip: kernel
FIX_LAYOUTS = {"bad_attention_f32": {
    "q": Array(("B", "K", "G", "D")),
    "k_pages": Array((PAGES, "ps", "K", "D")),
    "v_pages": Array((PAGES, "ps", "K", "D")),
    "page_table": Array(("B", "MP")),
    "seq_lens": Array(("B",)),
    "out": Array(("B", "K", "G", "D")),
}}
FIX_WALKS = {"bad_attention_f32": Walk(("seq_lens",))}


@pytest.fixture(scope="module")
def bad_ops():
    return _load(BAD_TREE / "kernels" / "bad_kernel" / "ops.py",
                 "bad_kernel_ops")


@pytest.fixture(scope="module")
def bad_entries():
    return kernel_check.read_entries(BAD_TREE / "csrc")


def _bad_calls(ops, wrapper, lens=(13, 6), table=None):
    """One capture of a fixture wrapper on meta floats and CPU ints."""
    mk = kernel_check.Inputs("meta", "cpu")
    B, K, G, D, ps, P, MP = 2, 2, 2, 16, 4, 8, 4
    pt = table if table is not None else \
        np.arange(1, B * MP + 1).reshape(B, MP) % P
    with kernel_check.capture(modules={"bad_kernel": ops}) as rec:
        getattr(ops, wrapper)(mk.f(B, K, G, D), mk.f(P, ps, K, D),
                              mk.f(P, ps, K, D), mk.i(pt), mk.i(lens))
    return rec.calls


def _audit(calls, entries, rules=None):
    return kernel_check.audit(calls, entries, rules, layouts=FIX_LAYOUTS,
                              walks=FIX_WALKS)


def test_kernel_parser_reads_the_signature(bad_entries):
    e = bad_entries["bad_attention_f32"]
    assert (e.ret, e.line, e.is_launch) == ("int", 6, True)
    assert [(p.ctype, p.name) for p in e.params[:6]] == [
        ("const float*", "q"), ("const float*", "k_pages"),
        ("const float*", "v_pages"), ("const int*", "page_table"),
        ("const int*", "seq_lens"), ("float*", "out")]
    assert len(e.params) == 16 and e.params[-1].ctype == "void*"
    q = bad_entries["bad_unreached_bytes"]
    assert (q.ret, q.is_launch, q.params) == \
        ("long long", False, (kernel_check.Param("int", "B"),))
    # the port's fourteen entries: ten launches (the five kernels at fp32
    # and bf16), four queries
    port = kernel_check.read_entries(SRC / "csrc")
    assert len(port) == 14
    assert sum(e.is_launch for e in port.values()) == 10
    bf = port["paged_decode_attention_bf16"]
    assert [(p.ctype, p.pointee) for p in bf.params[:3]] == \
        [("const elem::bf16*", "elem::bf16")] * 3
    # the SSD scan's bf16 instance: x, B and C bf16, dt, dA, y, state fp32
    ssd = port["ssd_chunk_scan_bf16"]
    assert [(p.name, p.pointee) for p in ssd.params[:7]] == [
        ("x", "elem::bf16"), ("dt", "float"), ("da", "float"),
        ("B", "elem::bf16"), ("C", "elem::bf16"), ("y", "float"),
        ("st", "float")]


def test_kernel_good_wrapper_is_clean(bad_ops, bad_entries):
    calls = _bad_calls(bad_ops, "good")
    assert [c.kind for c in calls] == ["launch"]
    assert _audit(calls, bad_entries) == []


# case -> (rule, wrapper, capture keywords) that trips it
KERNEL_TRIPS = {
    "abi_count": ("kernel-abi", "short_count", {}),
    "abi_dtype": ("kernel-abi", "float_table", {}),
    "extent": ("kernel-extent", "wide_head", {}),
    "walk_keys": ("kernel-page-walk", "one_page", {}),
    "walk_ids": ("kernel-page-walk", "good",
                 {"table": np.array([[1, 2, 9, 0], [3, -1, 0, 0]])}),
}


@pytest.mark.parametrize("case", sorted(KERNEL_TRIPS))
def test_kernel_launch_rule_trips_and_goes_quiet(case, bad_ops,
                                                 bad_entries):
    rule, wrapper, kw = KERNEL_TRIPS[case]
    calls = _bad_calls(bad_ops, wrapper, **kw)
    found = _audit(calls, bad_entries)
    assert rule in _rules(found), [f.format() for f in found]
    assert all(f.path == "csrc/bad_kernel.cu" and f.line == 6
               for f in found)
    off = _audit(calls, bad_entries, kernel_check.RULES - {rule})
    assert rule not in _rules(off)


def test_kernel_abi_checks_queries(bad_ops, bad_entries):
    with kernel_check.capture(modules={"bad_kernel": bad_ops}) as rec:
        assert bad_ops.unsized(None) == 0
    found = _audit(rec.calls, bad_entries)
    assert [f.rule for f in found] == ["kernel-abi"]
    assert "B (int) gets float" in found[0].message


def test_kernel_abi_holds_each_dtype_to_its_entry():
    """The paged decode probes, fp32 and bf16, are clean against their own
    entries; each launch audited against its twin of the other dtype (a
    bf16 tensor where the source says ``const float*``, and the reverse)
    gives a kernel-abi finding for each float operand, naming its dtype."""
    _abi_holds_dtypes("paged_decode_attention", "paged_decode_attention",
                      ["q", "k_pages", "v_pages", "out"])


def test_kernel_abi_holds_ssd_dtypes_to_their_entry():
    """The SSD scan's probes, fp32 and bf16, are clean against their own
    entries; audited against the other dtype's entry, each launch gives a
    kernel-abi finding for x, B and C only: dt, dA, y and the state are
    fp32 in both instances."""
    _abi_holds_dtypes("ssd_scan", "ssd_chunk_scan", ["x", "B", "C"])


def _abi_holds_dtypes(family, stem, operands):
    entries = kernel_check.read_entries(SRC / "csrc")
    with kernel_check.capture(
            modules=kernel_check.family_modules([family])) as rec:
        for mode in kernel_check.probe_modes(families=[family])[family]:
            rec.mode = mode.name
            mode.run()
    launches = [c for c in rec.calls if c.kind == "launch"]
    assert {c.entry for c in launches} == {f"{stem}_f32", f"{stem}_bf16"}
    assert kernel_check.audit(rec.calls, entries) == []
    twin = {f"{stem}_f32": f"{stem}_bf16", f"{stem}_bf16": f"{stem}_f32"}
    for c in launches:
        found = kernel_check.audit(
            [dataclasses.replace(c, entry=twin[c.entry])], entries,
            {"kernel-abi"})
        want = "bfloat16" if c.entry.endswith("bf16") else "float32"
        # each float operand of the element type, of the other dtype
        assert [f.rule for f in found] == ["kernel-abi"] * len(operands), \
            found
        assert all(f"gets a torch.{want} tensor" in f.message
                   for f in found), found
        assert [f.message.split(": ")[1].split(" ")[0] for f in found] \
            == operands, found


def test_kernel_stale_spec_trips_and_goes_quiet(bad_entries):
    stale = {"bad_attention_f32": {
        **FIX_LAYOUTS["bad_attention_f32"],
        "q": Array(("B", "K", "G", "D"), ("sb", "ss", "sh", 1))},
        "gone_f32": {}}
    walks = {"bad_attention_f32": Walk(("lens",))}
    found = kernel_check.check_layouts(bad_entries, stale, walks)
    msgs = [f.message for f in found]
    assert _rules(found) == {"kernel-stale-spec"}
    assert any("'sb'" in m for m in msgs), msgs
    assert any("no csrc" in m for m in msgs), msgs
    assert any("'lens'" in m for m in msgs), msgs
    assert kernel_check.check_layouts(bad_entries, FIX_LAYOUTS,
                                      FIX_WALKS) == []
    assert kernel_check.check_layouts(
        bad_entries, stale, walks,
        rules=kernel_check.RULES - {"kernel-stale-spec"}) == []


@pytest.mark.parametrize("rule", ["kernel-static-args", "kernel-uncovered"])
def test_kernel_tree_rule_trips_and_goes_quiet(rule):
    found = kernel_check.run(BAD_TREE)
    assert rule in _rules(found)
    if rule == "kernel-uncovered":
        assert {f.symbol for f in found if f.rule == rule} == {
            "bad_kernel", "orphan", "bad_attention_f32",
            "bad_unreached_bytes"}
    else:
        msgs = sorted(f.message for f in found if f.rule == rule)
        assert len(msgs) == 2 and "'pages_start'" in msgs[0] \
            and "'window'" in msgs[1], msgs
    off = kernel_check.run(BAD_TREE, rules=kernel_check.RULES - {rule})
    assert rule not in _rules(off)


# --------------------------------------------------------------- coverage
def test_port_spec_edges_are_the_scheduler_transitions():
    from repro_torch.serving import scheduler
    spec = fsm_check.default_spec()
    assert set(spec.edges) == set(scheduler.TRANSITIONS)
    drivable = {e for edges in spec.assignment_sites.values()
                for e in edges}
    assert drivable == set(scheduler.TRANSITIONS)
    assert fsm_check.run(SRC) == []


def test_probes_cover_every_family_and_entry():
    fams = {d.name for d in (SRC / "kernels").iterdir()
            if d.is_dir() and (d / "ops.py").is_file()}
    assert fams == set(kernel_check.PROBES)
    from repro_torch.kernels import common
    from repro_torch.kernels.paged_decode_attention import ops
    before = ops.paged_decode_attention_gqa.launches
    with kernel_check.capture() as rec:
        for modes in kernel_check.probe_modes().values():
            for mode in modes:
                rec.mode = mode.name
                mode.run()
    assert {c.entry for c in rec.calls} == \
        set(kernel_check.read_entries(SRC / "csrc"))
    # every launch mode of the reference's probes, plus the port's own
    by_family = {}
    for c in rec.calls:
        if c.kind == "launch":
            by_family.setdefault(c.family, []).append(c.mode)
    assert by_family == {
        "paged_decode_attention": ["full_walk", "live_bound",
                                   "window_late_start",
                                   "bf16_window_late_start"],
        "paged_prefill_attention": ["full_walk", "live_bound",
                                    "window_late_start", "bf16_full_walk",
                                    "bf16_live_bound",
                                    "bf16_window_late_start"],
        "decode_attention": ["gqa", "gqa_irregular", "kv_strided",
                             "head_expanded", "cross", "bf16_kv_strided"],
        "flash_attention": ["causal", "window", "non_causal", "irregular",
                            "gqa_strided", "bf16_gqa_strided", "bf16_causal",
                            "bf16_window", "bf16_non_causal",
                            "bf16_irregular"],
        "ssd_scan": ["kernel_layout", "model_layout", "bf16_kernel_layout",
                     "bf16_model_layout"],
    }
    # each bf16 mode launches its kernel's bf16 entry, the others the fp32
    for c in rec.calls:
        if c.kind == "launch":
            assert c.entry.endswith("_bf16") == c.mode.startswith("bf16"), c
    entries = kernel_check.read_entries(SRC / "csrc")
    assert kernel_check.audit(rec.calls, entries) == []
    # the capture restores the wrappers' names and counters
    assert ops.launch is common.launch and ops.query is common.query
    assert ops.paged_decode_attention_gqa.launches == before


# ------------------------------------------------------------ the gate
def test_clean_tree_end_to_end(capsys):
    """The acceptance gate: every pass over src/repro_torch reports
    nothing once the allowlist is applied, and every entry is justified
    and matches a live finding."""
    assert cli.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    findings = []
    for mod in (kernel_check, fsm_check, trace_lint, page_ledger):
        findings.extend(mod.run(SRC))
    reported, suppressed, problems = apply_allowlist(findings,
                                                     allowlist.ALLOWLIST)
    assert not reported and not problems, (reported, problems)
    for e in allowlist.ALLOWLIST:
        assert e.reason.strip() and any(e.matches(f) for f in suppressed), e


@pytest.mark.parametrize("root", [
    FIX / "bad_hot", BAD_TREE, REF_FIX, REF_FIX / "bad_trace"])
def test_cli_exits_1_on_each_fixture(root, capsys):
    assert cli.main(["--root", str(root)]) == 1
    assert "ALLOWLIST" not in capsys.readouterr().out


@pytest.mark.parametrize("bad", ["reasonless", "stale"])
def test_cli_exits_2_on_an_allowlist_violation(bad, monkeypatch, capsys):
    entry = AllowEntry(rule="host-sync", path="serving/engine.py",
                       symbol="ContinuousEngine.step", reason=" ") \
        if bad == "reasonless" else \
        AllowEntry(rule="host-sync", path="serving/engine.py",
                   symbol="ContinuousEngine.no_such", reason="gone")
    monkeypatch.setattr(cli, "ALLOWLIST", allowlist.ALLOWLIST + (entry,))
    assert cli.main(["--passes", "trace"]) == 2
    said = {"reasonless": "missing reason", "stale": "stale"}[bad]
    assert said in capsys.readouterr().out


def test_cli_writes_json(tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["--passes", "fsm,ledger", "--json", str(out)]) == 0
    import json
    data = json.loads(out.read_text())
    assert data["findings"] == [] and len(data["suppressed"]) == 2


# ------------------------------------------- the engine keeps the promise
def test_engine_walks_keep_the_page_walk_promise(monkeypatch):
    """The paged calls of a CPU serve, with sliding-window layers walked
    from late pages, held to the page-walk rule: the rows the decode step
    uses, and every real prefill row."""
    from conftest import tiny_cfg
    from repro_torch.models import attention
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ContinuousEngine
    cfg = ArchConfig(**dataclasses.asdict(tiny_cfg(
        "dense", name="window-tiny", prefill_chunk=8, n_layers=3,
        sliding_window=6, local_global_ratio=2, cache_layout="paged")))
    bundle = build_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    seen = {"decode": [], "prefill": [], "active": None}
    dec_model, dec, pre = (attention.paged_decode_attention,
                           attention.paged_decode_attention_gqa,
                           attention.paged_prefill_attention_gqa)

    def decode_layer(*args, **kw):
        seen["active"] = args[6].numpy().copy()
        return dec_model(*args, **kw)

    def walk(kp, pt, kw):
        MP = pt.shape[1]
        end = MP if kw.get("pages_bound") is None else kw["pages_bound"]
        return (pt.numpy().copy(), kp.shape[0], kp.shape[1],
                kw.get("pages_start", 0), end, kw.get("window", 0))

    def decode(q, kp, vp, pt, lens, **kw):
        seen["decode"].append((walk(kp, pt, kw), lens.numpy().copy(),
                               seen["active"]))
        return dec(q, kp, vp, pt, lens, **kw)

    def prefill(q, kp, vp, pt, start, total, **kw):
        seen["prefill"].append((walk(kp, pt, kw), start.numpy().copy(),
                                total.numpy().copy()))
        return pre(q, kp, vp, pt, start, total, **kw)

    monkeypatch.setattr(attention, "paged_decode_attention", decode_layer)
    monkeypatch.setattr(attention, "paged_decode_attention_gqa", decode)
    monkeypatch.setattr(attention, "paged_prefill_attention_gqa", prefill)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 200, n).astype(np.int32)
               for n in (31, 9, 44, 17, 26)]
    eng = ContinuousEngine(bundle, model, max_new_tokens=7, n_slots=3,
                           max_seq=64, page_size=4)
    for p in prompts:
        eng.submit(p)
    eng.run()
    assert seen["decode"] and seen["prefill"]
    assert any(w[3] > 0 for w, *_ in seen["decode"] + seen["prefill"])
    for w, lens, active in seen["decode"]:
        assert kernel_check.page_walk_problems(
            *w, lens=lens, rows=active) == []
    for w, start, total in seen["prefill"]:
        assert kernel_check.page_walk_problems(
            *w, start=start, total=total) == []


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_cuda_probes_pass_the_audit_and_match_plain_versions():
    """Every probe mode on CUDA tensors through the real launch: no
    finding, and each output within 1e-4 of its plain version (relative to
    the output's scale for the SSD scan); a bf16 mode's within 2e-2 in
    allclose form (rtol = atol), the reference's bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    entries = kernel_check.read_entries(SRC / "csrc")
    modes = kernel_check.probe_modes("cuda", "cuda", seed=1)
    with kernel_check.capture(live=True) as rec:
        for family, family_modes in modes.items():
            for mode in family_modes:
                rec.mode = mode.name
                got = mode.run()
                torch.cuda.synchronize()
                want = mode.plain()
                pairs = zip(got, want) if isinstance(got, tuple) \
                    else [(got, want)]
                for a, b in pairs:
                    if a.dtype == torch.bfloat16:
                        torch.testing.assert_close(
                            a.float(), b.float(), rtol=2e-2, atol=2e-2,
                            msg=f"{family}[{mode.name}]")
                        continue
                    tol = 1e-4 * max(1.0, b.abs().max().item()) \
                        if mode.scaled else 1e-4
                    err = (a - b).abs().max().item()
                    assert err <= tol, (family, mode.name, err)
    assert sum(c.kind == "launch" for c in rec.calls) == 30
    found = kernel_check.audit(rec.calls, entries)
    assert not found, [f.format() for f in found]
