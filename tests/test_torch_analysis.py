"""The port's static analysis (``pos_evolution_tpu_torch.analysis``) against
the JAX package's (``pos_evolution_tpu.analysis``).

- The shared rules (PEV002, PEV005, PEV006, PEV007, PEV101, PEV102) give
  identical findings (code, path, line, context, message) under the same
  scope tables: over the JAX package, ``scripts/`` and the JAX doctor's
  zoo with the JAX tables, and over the port with the port's.
- The torch rules (PEV001, PEV003, PEV004) give, on the torch form of each
  of ``tests/test_analysis.py``'s cases, the JAX rule's verdict on its
  JAX form.
- The doctor finds the JAX doctor's counts, the gate is clean on the port
  with the port's own baseline (every entry justified), and the CLI's
  exit codes and flags are the JAX CLI's.

All of it is stdlib ``ast``: no JAX compile, no torch import.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from pos_evolution_tpu.analysis import AnalysisConfig as JaxConfig  # noqa: E402
from pos_evolution_tpu.analysis import analyze_source as jax_analyze_source  # noqa: E402
from pos_evolution_tpu.analysis import doctor as jax_doctor  # noqa: E402
from pos_evolution_tpu.analysis import engine as jax_engine  # noqa: E402
from pos_evolution_tpu_torch.analysis import (  # noqa: E402
    AnalysisConfig,
    Baseline,
    analyze_source,
)
from pos_evolution_tpu_torch.analysis import doctor, engine  # noqa: E402
from pos_evolution_tpu_torch.analysis.__main__ import DEFAULT_BASELINE, main  # noqa: E402
from pos_evolution_tpu_torch.analysis.core import all_rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = frozenset({"PEV002", "PEV005", "PEV006", "PEV007", "PEV101", "PEV102"})
TABLES = ("stateless_strict", "stateless_decision", "hot_modules", "threaded_modules")


def _tables(eng) -> dict:
    return {"stateless_strict": eng.STATELESS_STRICT,
            "stateless_decision": eng.STATELESS_DECISION,
            "hot_modules": eng.HOT_MODULES, "threaded_modules": eng.THREADED_MODULES}


def _rows(results) -> list:
    return [(f.code, f.path, f.line, f.context, f.message, f.key, f.col)
            for r in results for f in r.findings]


# --- the shared rules: identical findings -------------------------------------

_ANALYZE = """
import json, sys
sys.path.insert(0, {repo!r})
from {pkg}.analysis import AnalysisConfig, analyze_paths
from {tables_pkg}.analysis import engine as tables
config = AnalysisConfig(rules=frozenset({shared!r}), stateless_strict=tables.STATELESS_STRICT,
                        stateless_decision=tables.STATELESS_DECISION,
                        hot_modules=tables.HOT_MODULES, threaded_modules=tables.THREADED_MODULES)
rows = [(f.code, f.path, f.line, f.context, f.message, f.key, f.col)
        for r in analyze_paths({paths!r}, root={repo!r}, config=config) for f in r.findings]
print(json.dumps(rows))
"""


@pytest.fixture(scope="module")
def shared_findings():
    """Both analyzers' shared-rule findings over each tree, each tree under
    one package's scope tables (the same tables for both analyzers): four
    analyses, each in a process of its own (stdlib only), run together."""
    trees = {"jax": (["pos_evolution_tpu", "scripts"], "pos_evolution_tpu"),
             "port": (list(engine.DEFAULT_PATHS), "pos_evolution_tpu_torch")}
    procs = {(tree, pkg): subprocess.Popen(
        [sys.executable, "-c", _ANALYZE.format(repo=REPO, pkg=pkg, tables_pkg=tables_pkg,
                                               shared=sorted(SHARED), paths=paths)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for tree, (paths, tables_pkg) in trees.items()
        for pkg in ("pos_evolution_tpu", "pos_evolution_tpu_torch")}
    out = {}
    for (tree, pkg), proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr
        out.setdefault(tree, {})[pkg] = [tuple(r) for r in json.loads(stdout)]
    return {tree: (rows["pos_evolution_tpu"], rows["pos_evolution_tpu_torch"])
            for tree, rows in out.items()}


def test_the_scope_tables_mirror_the_jax_tables():
    """Each table names the port's counterpart of each JAX entry (the
    backend renamed, ``parallel/`` waiting for the multi-GPU mode)."""
    for name, port in _tables(engine).items():
        mirrored = tuple(p.replace("pos_evolution_tpu/", "pos_evolution_tpu_torch/")
                         .replace("jax_backend.py", "torch_backend.py")
                         for p in _tables(jax_engine)[name]
                         if not p.startswith("pos_evolution_tpu/parallel/"))
        assert port == mirrored, name
    assert engine.DEFAULT_PATHS == ("pos_evolution_tpu_torch", "chip_smoke.py")


@pytest.mark.parametrize("code", sorted(SHARED))
@pytest.mark.parametrize("tree", ["jax", "port"])
def test_shared_rule_findings_equal_the_jax_analyzers(shared_findings, tree, code):
    jax_rows, port_rows = shared_findings[tree]
    assert [r for r in port_rows if r[0] == code] == [r for r in jax_rows if r[0] == code]


def test_shared_rules_find_the_ports_own_shm_races(shared_findings):
    """The lockset pass sees ``ShmViewBoard`` as thread-shared since its
    thread lock (a repair of the port's copy): both analyzers report the
    same four PEV101, which the port's baseline adjudicates."""
    _, port_rows = shared_findings["port"]
    shm = [(r[0], r[3]) for r in port_rows if r[1] == "pos_evolution_tpu_torch/serve/shm.py"]
    assert shm == [("PEV101", "ShmViewBoard.publish")] * 2 + [
        ("PEV101", "ShmViewBoard.current")] * 2


def test_shared_rules_on_the_jax_doctors_zoo():
    got = analyze_source(jax_doctor.DOCTOR_SOURCE, jax_doctor.DOCTOR_RELPATH,
                         AnalysisConfig(rules=SHARED, **{
                             k: getattr(jax_doctor.doctor_config(), k) for k in TABLES}))
    want = jax_analyze_source(jax_doctor.DOCTOR_SOURCE, jax_doctor.DOCTOR_RELPATH,
                              JaxConfig(rules=SHARED, **{
                                  k: getattr(jax_doctor.doctor_config(), k) for k in TABLES}))
    assert _rows([got]) == _rows([want])
    assert sorted({r[0] for r in _rows([got])}) == sorted(SHARED)


# --- the torch rules: each JAX case in its torch form -------------------------

# (case, JAX form, torch form, config kwargs, expected codes): the JAX forms
# are tests/test_analysis.py's; each torch form must get the JAX verdict
_CACHED = """\
_CACHE = {}

def _cached(key, build):
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]
"""
_HOT = {"hot_modules": ("mod.py",)}
_PEV004_ONLY = {"rules": frozenset({"PEV004"})}

CASES = [
    # PEV001: TestFreshJitClosure
    ("pr7_per_call_closure_flags", """\
import jax

def reconstruct_check_device(cells, mask):
    @jax.jit
    def _check(c, m):
        return (c * m).sum()
    return _check(cells, mask)
""", """\
import torch

def reconstruct_check_device(cells, mask):
    @torch.compile
    def _check(c, m):
        return (c * m).sum()
    return _check(cells, mask)
""", {}, ["PEV001"]),
    ("pr7_module_singleton_fix_is_clean", """\
import jax

@jax.jit
def _reconstruct_check(c, m):
    return (c * m).sum()

def reconstruct_check_device(cells, mask):
    return _reconstruct_check(cells, mask)
""", """\
import torch

@torch.compile
def _reconstruct_check(c, m):
    return (c * m).sum()

def reconstruct_check_device(cells, mask):
    return _reconstruct_check(cells, mask)
""", {}, []),
    ("memoized_for_builder_is_exempt", "import jax\n\n" + _CACHED + """
def epoch_step_for(mesh):
    return _cached(("epoch", mesh), lambda: jax.jit(lambda r: r + 1))
""", "import torch\n\n" + _CACHED + """
def epoch_step_for(device):
    return _cached(("epoch", device), lambda: torch.compile(lambda r: r + 1))
""", {}, []),
    ("helper_core_called_only_from_for_builder_is_exempt", "import jax\n\n" + _CACHED + """
def _epoch_core(mesh):
    def step(reg):
        return reg
    return jax.jit(step)

def epoch_step_for(mesh):
    return _cached(("epoch", mesh), lambda: _epoch_core(mesh))
""", "import torch\n\n" + _CACHED + """
def _epoch_core(device):
    def step(reg):
        return reg
    return torch.jit.script(step)

def epoch_step_for(device):
    return _cached(("epoch", device), lambda: _epoch_core(device))
""", {}, []),
    ("module_singleton_global_memo_is_exempt", """\
import jax

_DEVICE = None

def _device():
    global _DEVICE
    if _DEVICE is None:
        _DEVICE = {"jit": jax.jit(lambda x: x)}
    return _DEVICE
""", """\
import ctypes

_LIB = None

def _library():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL("libagg_sig.so")
    return _LIB
""", {}, []),
    ("stacked_decorators_report_once", """\
import jax
from functools import partial
from jax.experimental.shard_map import shard_map

def dry_run_builder(mesh):
    @jax.jit
    @partial(shard_map, mesh=mesh)
    def step(reg):
        return reg
    return step
""", """\
import torch
from functools import partial

def dry_run_builder(example):
    @torch.compile
    @partial(torch.jit.trace, example_inputs=example)
    def step(reg):
        return reg
    return step
""", {}, ["PEV001"]),
    ("compat_shim_defining_the_constructor_name_is_exempt", """\
from jax.experimental.shard_map import shard_map as _experimental

def shard_map(f, **kwargs):
    if "check_vma" in kwargs:
        kwargs["check_rep"] = kwargs.pop("check_vma")
    return _experimental(f, **kwargs)
""", """\
import torch

def compile(fn, **kwargs):
    kwargs.pop("fullgraph", None)
    return torch.compile(fn, **kwargs)
""", {}, []),
    ("aliased_jit_import_still_flags",
     "from jax import jit as J\n\ndef per_call(xs):\n    return J(lambda v: v * 2)(xs)\n",
     "from torch import compile as C\n\ndef per_call(xs):\n    return C(lambda v: v * 2)(xs)\n",
     {}, ["PEV001"]),
    ("module_level_decorated_def_is_the_idiom", """\
import jax
from functools import partial

@partial(jax.jit, static_argnames=("capacity",))
def head_and_weights(store, capacity):
    return store
""", """\
import torch
from functools import partial

@partial(torch.compile, dynamic=False)
def head_and_weights(store, capacity):
    return store
""", {}, []),
    # PEV003: TestHostSync
    ("item_in_hot_loop_flags",
     "def drain(batches):\n    total = 0.0\n    for b in batches:\n"
     "        total += b.item()\n    return total\n",
     "def drain(batches):\n    total = 0.0\n    for b in batches:\n"
     "        total += b.item()\n    return total\n", _HOT, ["PEV003"]),
    ("item_outside_loop_is_fine",
     "def total_of(x):\n    return x.item()\n",
     "def total_of(x):\n    return x.tolist()\n", _HOT, []),
    ("float_of_traced_expr_in_loop_flags",
     "import jax.numpy as jnp\ndef drain(batches):\n    out = []\n    for b in batches:\n"
     "        out.append(float(jnp.sum(b)))\n    return out\n",
     "import torch\ndef drain(batches):\n    out = []\n    for b in batches:\n"
     "        out.append(float(torch.sum(b)))\n    return out\n", _HOT, ["PEV003"]),
    ("comprehension_counts_as_a_loop",
     "def drain(batches):\n    return [b.item() for b in batches]\n",
     "def drain(batches):\n    return [b.tolist() for b in batches]\n", _HOT, ["PEV003"]),
    ("cold_module_not_in_scope",
     "def drain(batches):\n    return [b.item() for b in batches]\n",
     "def drain(batches):\n    return [b.cpu() for b in batches]\n",
     {"hot_modules": ()}, []),
    # PEV004: TestDonationGuard
    ("unguarded_donation_flags",
     "import jax\nstep = jax.jit(lambda c, x: c + x, donate_argnums=(0,))\n",
     "import torch\nstaging = torch.empty(8).pin_memory()\n", {}, ["PEV004"]),
    ("inline_ifexp_guard_passes",
     "import jax\ndef build(donate_ok):\n    return jax.jit(lambda c: c,\n"
     "                   donate_argnums=(0,) if donate_ok else ())\n",
     "import torch\ndef stage(x, dev):\n"
     "    return x.to(dev, non_blocking=True) if dev.type == \"cuda\" else x\n",
     _PEV004_ONLY, []),
    ("donate_param_passes",
     "import jax\ndef build(fn, donate=False):\n"
     "    return jax.jit(fn, donate_argnums=(0,) if donate else ())\n",
     "import torch\ndef stage(x, cuda=False):\n"
     "    return x.pin_memory() if cuda else x\n", _PEV004_ONLY, []),
    ("module_backend_guard_passes",
     "import jax\n_donated = jax.jit(lambda c: c, donate_argnums=(0,))\n"
     "_plain = jax.jit(lambda c: c)\ndef pick():\n"
     "    return _plain if jax.default_backend() == 'cpu' else _donated\n",
     "import torch\n_pinned = torch.empty(8).pin_memory\n_plain = torch.empty\n"
     "def pick():\n    return _pinned if torch.cuda.is_available() else _plain\n",
     {}, []),
    ("docstring_mention_of_the_guard_does_not_exempt",
     '"""This module never calls jax.default_backend()."""\nimport jax\n'
     "step = jax.jit(lambda c: c, donate_argnums=(0,))\n",
     '"""This module never calls torch.cuda.is_available()."""\nimport torch\n'
     "staging = torch.empty(8).pin_memory()\n", _PEV004_ONLY, ["PEV004"]),
]


def _codes(analyze, config_cls, source, cfg) -> list:
    result = analyze(source, "mod.py", config_cls(**cfg))
    assert result.parse_error is None, result.parse_error
    return [f.code for f in result.findings]


@pytest.mark.parametrize("case, jax_src, torch_src, cfg, want", CASES,
                         ids=[c[0] for c in CASES])
def test_torch_form_gets_the_jax_verdict(case, jax_src, torch_src, cfg, want):
    assert _codes(jax_analyze_source, JaxConfig, jax_src, cfg) == want
    assert _codes(analyze_source, AnalysisConfig, torch_src, cfg) == want


# the port's own forms of each bug class
TORCH_ONLY = [
    ("the kernel loader's module mapping is the memo",
     "import ctypes\n_LIBS = {}\n\ndef library(source):\n    lib = _LIBS.get(source)\n"
     "    if lib is None:\n        lib = _LIBS[source] = ctypes.CDLL(source)\n    return lib\n",
     {}, []),
    ("a library loaded per call flags",
     "import ctypes\n\ndef launch(source, *args):\n    return ctypes.CDLL(source).run(*args)\n",
     {}, ["PEV001"]),
    ("a graph captured in a loop at module level flags",
     "import torch\nfor n in (1, 2):\n    g = torch.cuda.CUDAGraph()\n",
     {"rules": frozenset({"PEV001"})}, ["PEV001"]),
    ("cpu copy in a hot loop flags once a chain",
     "def drain(xs):\n    return [x.cpu().numpy() for x in xs]\n", _HOT, ["PEV003"]),
    ("to cpu in a hot loop flags",
     "def drain(xs):\n    for x in xs:\n        x.to(\"cpu\")\n", _HOT, ["PEV003"]),
    ("synchronize in a hot loop flags",
     "import torch\ndef drain(xs, ev):\n    for x in xs:\n        torch.cuda.synchronize()\n"
     "        ev.synchronize()\n", {**_HOT, "rules": frozenset({"PEV003"})},
     ["PEV003", "PEV003"]),
    ("a device-type check guards its function",
     "import torch\ndef finish(dev):\n    if dev.type == \"cuda\":\n"
     "        torch.cuda.synchronize(dev)\n", {}, []),
    ("a stream on the CPU path flags",
     "import torch\ndef copy(x):\n    s = torch.cuda.Stream()\n"
     "    return x.to(\"cuda\", non_blocking=True)\n", {}, ["PEV004", "PEV004"]),
]


@pytest.mark.parametrize("case, src, cfg, want", TORCH_ONLY, ids=[c[0] for c in TORCH_ONLY])
def test_torch_rule_forms(case, src, cfg, want):
    assert _codes(analyze_source, AnalysisConfig, src, cfg) == want


def test_every_rule_keeps_its_jax_code():
    from pos_evolution_tpu.analysis.core import all_rules as jax_rules
    ours = {c for r in all_rules().values() for c in r.all_codes}
    theirs = {c for r in jax_rules().values() for c in r.all_codes}
    assert ours == theirs
    names = {c: r.name for r in all_rules().values() for c in r.all_codes}
    assert names["PEV001"] == "fresh-compiled-object"
    assert names["PEV004"] == "unguarded-device-only"


# --- doctor, gate and CLI -------------------------------------------------------

def test_doctor_finds_the_jax_doctors_counts(capsys):
    assert doctor.EXPECTED == jax_doctor.EXPECTED
    assert main(["--doctor"]) == doctor.DOCTOR_FINDINGS == 1
    out = capsys.readouterr().out
    for code, n in doctor.EXPECTED.items():
        assert out.count(f" {code} ") == n, code
    assert "jax" not in doctor.DOCTOR_SOURCE


def test_strict_gate_is_clean_on_the_port(capsys):
    rc = main(["--root", REPO, "--strict"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 new finding(s)" in out


def test_the_ports_baseline_is_its_own_and_justified():
    assert DEFAULT_BASELINE == os.path.join(REPO, "pos_evolution_tpu_torch", "analysis",
                                            "baseline.json")
    base = Baseline.load(DEFAULT_BASELINE)
    assert base.entries
    for e in base.entries:
        assert e["path"].startswith(("pos_evolution_tpu_torch/", "chip_smoke.py")), e
        assert len(e["justification"]) > 40 and "TODO" not in e["justification"], e


def test_stale_baseline_entry_fails_strict(tmp_path, capsys):
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({"version": 1, "entries": [{
        "code": "PEV003", "path": "pos_evolution_tpu_torch/analysis/core.py",
        "context": "gone", "key": "x.item()", "justification": "a finding long since fixed"}]}))
    argv = ["--root", REPO, "pos_evolution_tpu_torch/analysis", "--baseline", str(stale)]
    assert main(argv) == 0
    assert main(argv + ["--strict"]) == 2
    assert "stale baseline" in capsys.readouterr().out


def test_new_finding_is_rc1_and_write_baseline_absorbs_it(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f(xs):\n    return torch.compile(lambda v: v)(xs)\n")
    written = tmp_path / "written.json"
    argv = ["--root", str(tmp_path), "bad.py", "--baseline", "none"]
    assert main(argv + ["--write-baseline", str(written)]) == 1
    entries = json.loads(written.read_text())["entries"]
    assert [(e["code"], e["context"]) for e in entries] == [("PEV001", "f")]
    assert main(["--root", str(tmp_path), "bad.py", "--baseline", str(written),
                 "--strict"]) == 0
    capsys.readouterr()


def test_assume_scope_and_rules_filter(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text("import time\n\ndef decide(seed):\n    return time.time() > seed\n")
    argv = ["--root", str(tmp_path), "mod.py", "--baseline", "none"]
    assert main(argv) == 0
    assert main(argv + ["--assume-scope", "decision"]) == 0   # clocks are telemetry there
    assert main(argv + ["--assume-scope", "strict"]) == 1
    assert main(argv + ["--assume-scope", "strict", "--rules", "PEV006"]) == 0
    out = tmp_path / "report.json"
    assert main(argv + ["--assume-scope", "strict", "--json", str(out)]) == 1
    assert json.loads(out.read_text())["by_code"] == {"PEV002": 1}
    capsys.readouterr()


def test_missing_path_is_rc2(capsys):
    assert main(["--root", REPO, "no_such_dir", "--baseline", "none"]) == 2
    assert "does not exist" in capsys.readouterr().err
