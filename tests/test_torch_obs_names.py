"""Every obs name the JAX package emits, the port emits too.

Read from the sources with ``ast`` (neither package is imported): the
literal first argument of each call to the obs API — ``counter``,
``gauge``, ``histogram``, ``span``, ``emit``, ``note_transfer``,
``observe_call``, ``guard_scope``, ``allow_scope``, ``named_lock``,
``named_rlock``, ``mark`` — and, for an f-string, its literal prefix
(``f"pallas_probe/{label}"`` → ``"pallas_probe/"``). The JAX set must lie
inside the port's, apart from the names in ``EXCLUDED``, each with its
reason.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "large_scale_recommendation_tpu"
PORT_PKG = ROOT / "large_scale_recommendation_tpu_torch"

OBS_CALLS = frozenset({
    "counter", "gauge", "histogram", "span", "emit", "note_transfer",
    "observe_call", "guard_scope", "allow_scope", "named_lock",
    "named_rlock", "mark"})

EXCLUDED = {
    "jax_compile_s": "Tracer.install_jax_compile_hook times XLA compiles "
                     "through jax.monitoring; the card has no compile "
                     "funnel to hook (the kernel libraries' builds are "
                     "kernel_build_s)",
}


def _literal(node):
    """A call argument's literal string, an f-string's literal prefix, or
    ``None``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        prefix = ""
        for part in node.values:
            if not isinstance(part, ast.Constant):
                break
            prefix += part.value
        return prefix
    return None


def _callee(func):
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def obs_names(package: pathlib.Path) -> dict[str, str]:
    """``{name: "file:line" of its first use}`` over a package's sources."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and node.args
                    and _callee(node.func) in OBS_CALLS):
                name = _literal(node.args[0])
                if name is not None:
                    where = path.relative_to(package.parent)
                    out.setdefault(name, f"{where}:{node.lineno}")
    return out


@pytest.fixture(scope="module")
def names():
    return obs_names(JAX_PKG), obs_names(PORT_PKG)


def test_every_jax_obs_name_is_emitted_by_the_port(names):
    jax_names, port_names = names
    missing = {n: at for n, at in jax_names.items()
               if n not in port_names and n not in EXCLUDED}
    assert not missing, f"obs names the port does not emit: {missing}"


def test_every_exclusion_is_a_jax_name_the_port_lacks(names):
    jax_names, port_names = names
    for name, reason in EXCLUDED.items():
        assert reason
        assert name in jax_names and name not in port_names, name


@pytest.mark.parametrize("source,want", [
    ('reg.counter("a_total", k=1)', {"a_total"}),
    ('tracer.span(f"pallas_probe/{label}", key=k)', {"pallas_probe/"}),
    ('ev.emit("x.y", step=1); guard_scope("g")', {"x.y", "g"}),
    ('obs.gauge(name); mark(); x.histogram(f"{a}_s")', {""}),
    ('lock = named_rlock("online.apply_lock")', {"online.apply_lock"}),
    ('limiter.emit_batch_or_wait("n"); counter_of("c")', set()),
])
def test_the_collector_reads_literals_and_fstring_prefixes(tmp_path, source,
                                                           want):
    (tmp_path / "m.py").write_text(source + "\n")
    assert set(obs_names(tmp_path)) == want
