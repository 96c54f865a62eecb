"""The port's host-sync rule: nothing on ``PagedDecodeEngine``'s dispatch
path waits for the device.

The analogue of the JAX package's ``HostSyncInStepLoop`` rule, as an AST
scan that imports nothing of the JAX package. The dispatch path is the
engine's ``step``, ``run``, ``_decode_tick``, ``_spec_tick`` and
``_prefill_tick`` (the bodies of these methods: window drains and the
prefill-completion fetch live in the named helpers ``_drain``,
``_finish_prefill`` and ``sync``, once per window or per request, which is
where such a fetch belongs), the model functions a captured spec step runs
(``spec_step_paged``, ``verify_chunk_paged`` and what they call), and
every kernel wrapper that a captured step or chunk runs, with the helpers
of its own module that it calls; and the disaggregated path: the decode
tier's ``adopt`` and its handoff copy (``_get_handoff``,
``llama.paged_block_copy``/``_q``), the pair's ``step`` and ``_pump``, and
the prefill tier's ``step``; and the observatories' methods that the
dispatch path calls (the sampling gates, the timing bracket ``_tic`` /
``_toc`` and ``DeviceTimer.start`` / ``stop``, the build notes, the
``note_*`` seam calls, the flight recorder's ``record``, and the
telemetry's ``add_tokens`` / ``sample_*``). Banned there: ``.item()``,
``.cpu()``, ``.tolist()``, ``int()`` / ``float()`` / ``bool()`` of anything
but a constant, a name or shape arithmetic, ``torch.cuda.synchronize`` /
``Event.synchronize``, ``Event.elapsed_time`` and ``Event.query``.
``elapsed_time`` appears in the port only in ``DeviceTimer.resolve``, which
the engines reach through ``_resolve_timings`` only after a fetch.
"""

import ast
import inspect
import pathlib
import textwrap

import pytest

from grove_tpu_torch.models import llama
from grove_tpu_torch.ops import kvquant, moe, norms, paged, w8a16
from grove_tpu_torch.serving import engine, reqtrace, schedule, slo, xprof

STEP_FUNCS = ("step", "run", "_decode_tick", "_prefill_tick", "_spec_tick",
              "_decode_or_spec_tick")
# The model functions a captured spec step runs (the kernel wrappers they
# call are scanned below).
SPEC_FUNCS = ("spec_step_paged", "verify_chunk_paged", "decode_step_paged",
              "prefill_chunk_paged", "greedy_tokens", "_write_and_attend",
              "_decoder", "_logits", "embed", "_qkv_proj", "_projs",
              "_proj", "_matmul", "_attn_out", "_mlp_block", "_ffn",
              "layer_params", "_device_scalar")
# The disaggregated path: method names by class, and the copy's model
# functions.
DISAGG_METHODS = {"PagedDecodeEngine": ("adopt", "_get_handoff"),
                  "DisaggServing": ("step", "_pump"),
                  "PrefillEngine": ("step",)}
HANDOFF_FUNCS = ("paged_block_copy", "paged_block_copy_q")
WRAPPERS = {
    "w8a16_matmul": (w8a16, ("w8a16_matmul", "w8a16_matmul_group",
                             "_check", "_launch", "partition", "split_count",
                             "column_tiles", "_make_plan", "_plan_key",
                             "fragment_column", "slabs")),
    "dense_matmul": (w8a16, ("dense_matmul", "dense_matmul_group",
                             "dense_matmul_ref", "_check_dense",
                             "_dense_build", "_launch", "partition",
                             "split_count", "column_tiles", "slabs",
                             "_make_plan", "_plan_key", "dense_builds",
                             "dense_whole")),
    "paged_scatter": (kvquant, ("paged_scatter", "_check_rows", "_route",
                                "_launch", "_make_plan", "_aligned")),
    "paged_scatter_q": (kvquant, ("paged_scatter_q", "_check_scales",
                                  "_check_rows", "_route", "_launch",
                                  "_make_plan", "_aligned")),
    "paged_rope_scatter": (kvquant, ("paged_rope_scatter",
                                     "paged_rope_scatter_q", "_check_rows",
                                     "_check_scales", "_check_rope",
                                     "_route", "_launch", "_make_plan",
                                     "_aligned")),
    "rms_norm": (norms, ("rms_norm", "_check", "_route", "_launch")),
    "add_rms_norm": (norms, ("add_rms_norm", "add_rms_norm_ref", "_check",
                             "_route", "_launch")),
    "moe_route": (moe, ("moe_route", "_device_only", "_stream", "_raise")),
    "expert_matmul": (moe, ("expert_matmul", "expert_matmul_group",
                            "expert_build", "_plan", "_device_only",
                            "_stream", "_raise")),
    "moe_combine": (moe, ("moe_combine", "_device_only", "_stream",
                          "_raise")),
    "paged_attention": (paged, ("paged_decode_attention",
                                "paged_chunk_attention",
                                "paged_decode_attention_q8",
                                "paged_chunk_attention_q8", "_check",
                                "_kernel_args", "_launch", "_route",
                                "_one_query", "_scratch", "scratch_elems",
                                "n_spans")),
}
# The observatories' methods the dispatch path calls, by class.
OBSERVATORY_METHODS = [
    (engine._Observed, ("_tic", "_toc", "_tracked", "_note_build")),
    (engine.PagedDecodeEngine, ("_install", "_note_chunk")),
    (engine.DecodeEngine, ("_observed",)),
    (xprof.DeviceTimer, ("start", "stop")),
    (xprof.FlightRecorder, ("should_sample", "record")),
    (xprof.Observatory, ("should_sample", "record")),
    (xprof.CompileTracker, ("seen", "note_build", "_on_compile")),
    (reqtrace.RequestObservatory, (
        "should_sample", "note_enqueue", "note_admit", "note_prefix",
        "note_chunk", "note_prefill_done", "note_handoff",
        "note_decode_start", "note_preempt", "note_resume",
        "note_spec_window", "note_done", "adopt_trace", "live_trace",
        "_drop", "_retain_slowest")),
    (reqtrace.RequestTrace, ("add_span",)),
    (slo.EngineTelemetry, ("add_tokens", "sample_gauges", "sample_memory",
                           "sample_prefix", "sample_spec", "sample_handoff",
                           "sample_phases", "observe_request", "_observe")),
]
# Where the engines read the device timings: each of these fetches first.
RESOLVERS = {"DecodeEngine": ("admit_prompts", "_drain", "sync", "run"),
             "PagedDecodeEngine": ("_drain", "_take_first", "sync")}
FETCHES = {"cpu", "synchronize", "_sample_first", "prefill"}
SYNC_METHODS = {"item", "cpu", "tolist", "synchronize", "elapsed_time",
                "query"}
CASTS = {"int", "float", "bool"}


def _host_value(node: ast.AST) -> bool:
    """An argument that is plainly a host value: a constant, a name, an
    attribute chain ending in a size, or arithmetic over those."""
    if isinstance(node, (ast.Constant, ast.Name)):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in {"shape", "ndim"} or _host_value(node.value)
    if isinstance(node, ast.Subscript):  # x.shape[0]
        return isinstance(node.value, ast.Attribute) and \
            node.value.attr == "shape"
    if isinstance(node, ast.BinOp):
        return _host_value(node.left) and _host_value(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_value(node.operand)
    if isinstance(node, ast.Call):  # len(...), x.dim(), x.numel(), ...
        f = node.func
        return (isinstance(f, ast.Name) and f.id in {"len", "min", "max"}) \
            or (isinstance(f, ast.Attribute) and f.attr in {
                "dim", "numel", "element_size", "data_ptr"})
    return False


def host_syncs(fn_node: ast.AST) -> list[str]:
    """The device->host waits in a function body, as 'line: what'."""
    found = []
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
            found.append(f"{node.lineno}: .{f.attr}()")
        elif isinstance(f, ast.Name) and f.id in CASTS and node.args and \
                not _host_value(node.args[0]):
            found.append(f"{node.lineno}: {f.id}(<tensor?>)")
    return found


def _function(module, name: str) -> ast.FunctionDef:
    tree = ast.parse(textwrap.dedent(inspect.getsource(module)))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"{module.__name__}.{name} not found")


def _method(cls, name: str) -> ast.FunctionDef:
    tree = ast.parse(textwrap.dedent(inspect.getsource(cls)))
    for node in tree.body[0].body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"{cls.__name__}.{name} not found")


@pytest.mark.parametrize("name", STEP_FUNCS)
def test_paged_engine_dispatch_path_has_no_host_sync(name):
    assert host_syncs(_method(engine.PagedDecodeEngine, name)) == []


@pytest.mark.parametrize("cls,name", [
    (cls, name) for cls, names in sorted(DISAGG_METHODS.items())
    for name in names])
def test_disagg_dispatch_path_has_no_host_sync(cls, name):
    assert host_syncs(_method(getattr(engine, cls), name)) == []


@pytest.mark.parametrize("name", HANDOFF_FUNCS)
def test_handoff_copy_has_no_host_sync(name):
    assert host_syncs(_function(llama, name)) == []


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_kernel_wrappers_have_no_host_sync(wrapper):
    module, names = WRAPPERS[wrapper]
    for name in names:
        assert host_syncs(_function(module, name)) == [], name


@pytest.mark.parametrize("name", SPEC_FUNCS)
def test_spec_step_model_functions_have_no_host_sync(name):
    assert host_syncs(_function(llama, name)) == []


@pytest.mark.parametrize("cls,name", [
    (cls, name) for cls, names in OBSERVATORY_METHODS for name in names],
    ids=lambda v: getattr(v, "__name__", v))
def test_observatory_hooks_have_no_host_sync(cls, name):
    assert host_syncs(_method(cls, name)) == []


def _calls(fn_node: ast.AST, attr: str) -> list[int]:
    return [n.lineno for n in ast.walk(fn_node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == attr]


def test_device_timings_are_read_only_after_a_fetch():
    """``elapsed_time`` is in ``DeviceTimer.resolve`` alone; the engines
    call the resolver in the named methods only, each after a fetch that
    waited for the stream; and neither the dispatch path nor the
    scheduler reaches it."""
    pkg = pathlib.Path(engine.__file__).resolve().parents[1]
    found = []
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and \
                    _calls(node, "elapsed_time"):
                found.append((path.name, node.name))
    assert found == [("xprof.py", "resolve")]
    assert _calls(_method(engine._Observed, "_resolve_timings"),
                  "resolve")
    tree = ast.parse(inspect.getsource(engine))
    callers = {}
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if isinstance(fn, ast.FunctionDef) and \
                    fn.name != "_resolve_timings":
                lines = _calls(fn, "_resolve_timings") + _calls(fn, "resolve")
                if lines:
                    callers[(cls.name, fn.name)] = (fn, min(lines))
    assert set(callers) == {(c, n) for c, names in RESOLVERS.items()
                            for n in names}
    for (cls, name), (fn, line) in callers.items():
        fetched = [ln for f in FETCHES for ln in _calls(fn, f)]
        assert fetched and min(fetched) < line, (cls, name)
    for name in STEP_FUNCS:
        fn = _method(engine.PagedDecodeEngine, name)
        assert not _calls(fn, "_resolve_timings") and \
            not _calls(fn, "resolve"), name
    sched = ast.parse(inspect.getsource(schedule))
    assert not _calls(sched, "resolve") and \
        not _calls(sched, "_resolve_timings")


def test_every_captured_wrapper_is_scanned():
    scanned = {n for module, names in WRAPPERS.values() for n in names}
    assert {w.__name__ for w in engine._KERNEL_WRAPPERS} <= scanned


@pytest.mark.parametrize("src,want", [
    ("def f(x):\n    return x.sum().item()", ["2: .item()"]),
    ("def f(x):\n    return x.cpu()", ["2: .cpu()"]),
    ("def f(x):\n    return int(x[0])", ["2: int(<tensor?>)"]),
    ("def f(x):\n    torch.cuda.synchronize()", ["2: .synchronize()"]),
    ("def f(x):\n    return x.tolist()", ["2: .tolist()"]),
    ("def f(a, b):\n    return a.elapsed_time(b)", ["2: .elapsed_time()"]),
    ("def f(e):\n    return e.query()", ["2: .query()"]),
    ("def f(e):\n    e.synchronize()", ["2: .synchronize()"]),
    ("def f(x, n):\n    return int(n) + int(x.shape[0] * 2) + int(len(x))",
     []),
    ("def f(x):\n    return float(x.float().mean())",
     ["2: float(<tensor?>)"]),
])
def test_rule_flags_what_it_bans_and_only_that(src, want):
    assert host_syncs(ast.parse(src)) == want
