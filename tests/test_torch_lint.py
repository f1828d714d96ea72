"""torch-lint: the port's contract analyzer, against its corpus and the
reference's.

``repro_torch.analysis`` is the port of ``repro.analysis``.  Its corpus
(``tests/torch_lint_corpus/<rule>/{bad,good}_*.py``, in the port's idiom)
holds every rule to its contract: bad fixtures flag, good ones stay
clean.  The four rules the two linters share must give the reference's
findings, position for position, on the reference's corpus and over
``src/repro``; the two rules the port redefines (``use-after-consume``,
``build-in-hot-path``) must have a counterpart, under the same name, of
every function in the reference's ``use_after_donate`` and
``jit_in_hot_path`` fixtures, flagging where the reference's flags.  The
gate runs the CLI over the port's tree, as a user does.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.analysis as ref_analysis  # noqa: E402
from repro_torch.analysis import ALL_RULES, apis, lint_paths, lint_source  # noqa: E402
from repro_torch.analysis.engine import suppressions  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORPUS = Path(__file__).resolve().parent / "torch_lint_corpus"
REF_CORPUS = Path(__file__).resolve().parent / "lint_corpus"
CLI = REPO / "scripts" / "torch_lint.py"

RULE_NAMES = [r.name for r in ALL_RULES]
SHARED = ["unthreaded-pool", "stale-remap", "id-into-values", "unchecked-oom"]
#: the reference's rule -> the port's counterpart
COUNTERPARTS = {
    "use_after_donate": "use-after-consume",
    "jit_in_hot_path": "build-in-hot-path",
}


def _findings(path: Path, rule: str):
    return [
        f
        for f in lint_paths([path], select=[rule])
        if not f.suppressed and f.rule == rule
    ]


def _key(findings):
    return {(f.path, f.line, f.col, f.rule, f.suppressed) for f in findings}


# -- corpus --------------------------------------------------------------


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_bad_fixtures_flag(rule):
    corpus = CORPUS / rule.replace("-", "_")
    bad = sorted(corpus.glob("bad_*.py"))
    assert bad, f"no bad fixtures for {rule}"
    for path in bad:
        assert _findings(path, rule), f"{path.name} produced no {rule} finding"


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_good_fixtures_clean(rule):
    corpus = CORPUS / rule.replace("-", "_")
    good = sorted(corpus.glob("good_*.py"))
    assert good, f"no good fixtures for {rule}"
    for path in good:
        hits = _findings(path, rule)
        assert not hits, f"{path.name}: false positives {hits}"


def _functions(path: Path, ops: bool = True):
    """``{qualified name: (first line, last line)}`` of the top-level
    functions and the methods of top-level classes (without the custom
    ops a fixture defines to call, unless ``ops``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            if ops or not any("custom_op" in ast.unparse(d) for d in node.decorator_list):
                out[node.name] = (node.lineno, node.end_lineno)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{node.name}.{m.name}"] = (m.lineno, m.end_lineno)
    return out


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_every_bad_function_flags(rule):
    """Each function of a bad fixture breaks the contract itself (the
    corpus is the rule's spec, one case a function)."""
    for path in sorted((CORPUS / rule.replace("-", "_")).glob("bad_*.py")):
        lines = {f.line for f in _findings(path, rule)}
        for name, (lo, hi) in _functions(path, ops=False).items():
            assert any(lo <= ln <= hi for ln in lines), f"{path.name}:{name} does not flag"


def test_corpus_folders_are_the_rules():
    dirs = sorted(p.name for p in CORPUS.iterdir() if p.is_dir() and p.name != "__pycache__")
    assert dirs == sorted(r.replace("-", "_") for r in RULE_NAMES)


# -- against the reference -----------------------------------------------


@pytest.mark.parametrize(
    "target",
    [f"tests/lint_corpus/{r.replace('-', '_')}" for r in SHARED] + ["src/repro"],
)
def test_shared_rules_match_the_reference(target, monkeypatch):
    """The four shared rules give exactly the reference's findings."""
    monkeypatch.chdir(REPO)
    want = _key(ref_analysis.lint_paths([Path(target)], select=SHARED))
    got = _key(lint_paths([Path(target)], select=SHARED))
    assert got == want
    if target.startswith("tests/"):
        assert want, f"the reference flags nothing in {target}"


@pytest.mark.parametrize("ref_rule", sorted(COUNTERPARTS))
def test_reference_fixtures_have_counterparts(ref_rule):
    """Every function of the reference's fixtures for a JAX-only rule has
    a counterpart of the same name in the port's corpus, in a fixture of
    the same kind, that flags under the port's rule iff the reference's
    flags under its own."""
    rule = COUNTERPARTS[ref_rule]
    ours = {}
    for path in sorted((CORPUS / rule.replace("-", "_")).glob("*.py")):
        lines = {f.line for f in _findings(path, rule)}
        for name, (lo, hi) in _functions(path).items():
            ours[name] = (path.name.split("_")[0], any(lo <= ln <= hi for ln in lines))
    checked = 0
    for path in sorted((REF_CORPUS / ref_rule).glob("*.py")):
        ref_lines = {
            f.line
            for f in ref_analysis.lint_paths([path], select=[ref_rule.replace("_", "-")])
            if not f.suppressed
        }
        kind = path.name.split("_")[0]
        for name, (lo, hi) in _functions(path).items():
            flags = any(lo <= ln <= hi for ln in ref_lines)
            assert name in ours, f"no counterpart of {path.name}:{name}"
            assert ours[name] == (kind, flags), (name, ours[name], (kind, flags))
            checked += 1
    assert checked >= 6


# -- the contract table against the code ---------------------------------


def test_contract_table_matches_the_port():
    """Each entry of ``apis.py`` names a function of the port's module
    with the stated parameter at the stated call position."""
    entries = list(apis.contracts())
    assert len(entries) >= 30
    for module, func, idx, param in entries:
        obj = importlib.import_module(module)
        for part in func.split("."):
            obj = getattr(obj, part)
        params = list(inspect.signature(obj).parameters)
        if "." in func:  # a method: self is not passed at the call
            params = params[1:]
        assert idx < len(params) and params[idx] == param, (module, func, idx, param, params)


def test_contract_table_covers_the_port_apis():
    """APIs the reference's table lacks are in the port's."""
    assert apis.POOL_APIS["release_parents"] == (0, "pool")
    assert apis.STORE_APIS["clone_chain"] == (1, "store")
    for term in ("alloc", "oom_flag", "free_blocks", "check_invariants", "_check_oom"):
        module = apis.POOL_MODULE if term in ("alloc", "check_invariants") else apis.STORE_MODULE
        assert hasattr(importlib.import_module(module), term), term
    assert "_check_oom" in apis.OOM_SIGNALS and "oom_flag" in apis.OOM_SIGNALS


def test_package_imports_no_jax_torch_or_reference():
    pkg = REPO / "src" / "repro_torch" / "analysis"
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 13
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in {"jax", "jaxlib", "torch", "repro", "numpy"}, (path, name)


# -- engine mechanics ----------------------------------------------------


BAD_SNIPPET = """\
from repro_torch.core import pool as pool_lib

def f(pool, tables):
    pool_lib.add_refs(pool, tables)
    return pool
"""

CONSUME_SNIPPET = """\
def f(lm, params, tok, cache):
    snap = cache
    logits, cache = lm.decode_step(params, tok, cache)
    return snap
"""


def test_finding_positions_and_fields():
    (finding,) = lint_source(BAD_SNIPPET, path="x.py")
    assert finding.rule == "unthreaded-pool"
    assert (finding.path, finding.line, finding.col) == ("x.py", 4, 4)
    assert not finding.suppressed
    assert "x.py:4:4: unthreaded-pool" in finding.render()
    (finding,) = lint_source(CONSUME_SNIPPET, path="y.py")
    assert (finding.rule, finding.line, finding.col) == ("use-after-consume", 4, 11)
    assert "'snap'" in finding.message and "line 3" in finding.message


@pytest.mark.parametrize("snippet, line", [(BAD_SNIPPET, "    pool_lib.add_refs(pool, tables)"),
                                           (CONSUME_SNIPPET, "    return snap")])
def test_trailing_and_standalone_suppression(snippet, line):
    (finding,) = lint_source(snippet)
    trailing = snippet.replace(line, f"{line}  # repro-lint: disable={finding.rule}")
    assert lint_source(trailing)[0].suppressed
    standalone = snippet.replace(line, f"    # repro-lint: disable={finding.rule}\n{line}")
    assert lint_source(standalone)[0].suppressed


def test_disable_all_and_wrong_rule():
    line = "pool_lib.add_refs(pool, tables)"
    assert lint_source(BAD_SNIPPET.replace(line, f"{line}  # repro-lint: disable=all"))[0].suppressed
    wrong = BAD_SNIPPET.replace(line, f"{line}  # repro-lint: disable=use-after-consume")
    assert not lint_source(wrong)[0].suppressed


def test_suppression_parser_multi_rule():
    got = suppressions("x = 1  # repro-lint: disable=use-after-consume,build-in-hot-path\n")
    assert got == {1: {"use-after-consume", "build-in-hot-path"}}
    two = CONSUME_SNIPPET.replace(
        "    return snap", "    return snap  # repro-lint: disable=stale-remap,use-after-consume"
    )
    assert lint_source(two)[0].suppressed


def test_parse_error_is_a_finding():
    (finding,) = lint_source("def broken(:\n", path="bad.py")
    assert finding.rule == "parse-error"


def test_unknown_rule_rejected():
    with pytest.raises(KeyError):
        lint_source("x = 1\n", select=["use-after-donate"])


def test_nested_function_state_isolated():
    """Neither staleness nor an alias crosses into or out of a nested
    function."""
    src = """\
from repro_torch.core import pool as pool_lib

def outer(pool, ids, lm, params, tok, cache):
    snap = cache
    def inner(pool, ids, cache):
        logits, cache = lm.decode_step(params, tok, cache)
        return pool_lib.add_refs(pool, ids), snap
    pool = pool_lib.add_refs(pool, ids)
    return inner(pool, ids, cache), snap
"""
    assert lint_source(src) == []


def test_loop_carried_staleness_found_once():
    """The flow driver runs loop bodies twice; the engine dedupes."""
    src = """\
from repro_torch.core import pool as pool_lib

def f(pool, ids, xs):
    for _x in xs:
        pool2 = pool_lib.add_refs(pool, ids)
    return pool2

def g(lm, params, toks, cache):
    prev = cache
    for tok in toks:
        use(prev)
        logits, cache = lm.decode_step(params, tok, cache)
    return cache
"""
    hits = lint_source(src)
    assert [(f.rule, f.line) for f in hits] == [("unthreaded-pool", 5), ("use-after-consume", 11)]


def test_consume_branches_merge_and_rebinding_resurrects():
    src = """\
def f(lm, params, tok, cache, flag):
    if flag:
        logits, new = lm.decode_step(params, tok, cache)
    else:
        new = cache
    return cache.position

def g(lm, params, tok, cache):
    logits, new = lm.decode_step(params, tok, cache)
    cache = new
    return cache.position
"""
    hits = lint_source(src)
    assert [(f.rule, f.line) for f in hits] == [("use-after-consume", 6)]


# -- the CLI and the gate ------------------------------------------------


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, str(CLI), *args],
        capture_output=True,
        text=True,
        cwd=REPO,
    )


def test_port_tree_is_clean():
    """The acceptance bar: zero unsuppressed findings over the port and
    the chip script, every suppression justified on its line or above."""
    proc = _run_cli("src/repro_torch", "chip_smoke.py", "--json", "--show-suppressed")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["unsuppressed"] == 0
    for f in payload["findings"]:
        lines = (REPO / f["path"]).read_text().splitlines()
        here, above = lines[f["line"] - 1], lines[f["line"] - 2]
        comment = here if "repro-lint:" in here else above
        words = comment.split("repro-lint:")[0] + (above if comment is here else "")
        assert len(words.replace("#", "").split()) >= 3, f"unjustified suppression at {f}"


PLANTED = {
    "unthreaded-pool": (
        "from repro_torch.core import pool as pool_lib\n\n"
        "def f(pool, tables):\n"
        "    pool_lib.add_refs(pool, tables)\n"
        "    return pool\n"
    ),
    "stale-remap": (
        "from repro_torch.core import pool as pool_lib\n\n"
        "def f(pool):\n"
        "    pool, _ = pool_lib.compact(pool)\n"
        "    return pool\n"
    ),
    "id-into-values": (
        "import torch\n\n"
        "def f(tables, values):\n"
        "    return torch.cat([values, tables.view(-1)])\n"
    ),
    "use-after-consume": CONSUME_SNIPPET,
    "build-in-hot-path": (
        "import torch\n\n"
        "def f(fn, x):\n"
        "    return torch.compile(fn)(x)\n"
    ),
    "unchecked-oom": (
        "from repro_torch.core import store as store_lib\n\n"
        "def f(cfg, store, vals):\n"
        "    store = store_lib.append(cfg, store, vals)\n"
        "    return store_lib.read_last(cfg, store)\n"
    ),
}


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_cli_fails_on_planted_violation(rule, tmp_path):
    """The gate gates: a planted violation of each rule exits 1 and
    names the rule; ``--select`` of another rule passes it."""
    bad = tmp_path / "planted.py"
    bad.write_text(PLANTED[rule])
    proc = _run_cli(str(bad))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule in proc.stdout
    assert {ln.split(": ")[1] for ln in proc.stdout.splitlines()} == {rule}
    other = next(r for r in RULE_NAMES if r != rule)
    assert _run_cli(str(bad), "--select", other).returncode == 0


def test_cli_json_output(tmp_path):
    bad = tmp_path / "planted.py"
    bad.write_text(CONSUME_SNIPPET)
    proc = _run_cli(str(bad), "--json")
    payload = json.loads(proc.stdout)
    assert (payload["unsuppressed"], payload["suppressed"]) == (1, 0)
    assert payload["findings"][0]["rule"] == "use-after-consume"
    bad.write_text(CONSUME_SNIPPET.replace("return snap", "return snap  # repro-lint: disable=all"))
    proc = _run_cli(str(bad), "--json", "--show-suppressed")
    payload = json.loads(proc.stdout)
    assert proc.returncode == 0
    assert (payload["unsuppressed"], payload["suppressed"]) == (0, 1)
    assert payload["findings"][0]["suppressed"] is True


def test_cli_list_rules_and_select():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == RULE_NAMES
    assert _run_cli("src/repro_torch/analysis", "--select", "no-such-rule").returncode == 2
    assert _run_cli().returncode == 2  # no paths


def test_chip_smoke_lint_phase(tmp_path, capsys):
    """The chip script's lint phase lints the tree it ships with: it
    prints its ``lint`` line and passes a clean tree, and raises on a
    tree with a planted finding."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "chip_smoke.py").write_text("x = 1\n")
    planted = tmp_path / "src" / "repro_torch" / "planted.py"
    planted.write_text(PLANTED["use-after-consume"].replace(
        "    return snap", "    return snap  # repro-lint: disable=use-after-consume"))
    out = chip_smoke.lint_phase(tmp_path)
    assert (out["findings"], out["suppressed"]) == (0, 1)
    assert out["rules"] == RULE_NAMES
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"lint"} and line["lint"]["files"] == 2
    planted.write_text(PLANTED["build-in-hot-path"])
    with pytest.raises(RuntimeError, match="build-in-hot-path"):
        chip_smoke.lint_phase(tmp_path)
