"""Static contract for the port's studio: ``audio_raytracing_studio_tpu_torch/app/studio.py``
uses only the pinned gradio-4 API subset, and the port's headless runtime
(``app/_gradio_headless.py``) implements all of it — the port's copy of
``tests/test_gradio_subset.py``.

The port's studio imports real gradio when it is installed, and
``tests/test_torch_studio.py`` compares the two studios only under their
headless runtimes, so a ``gr.*`` call outside the subset would pass every
other port test.  This test closes that hole without gradio:

1. It AST-walks the port's ``app/studio.py`` and collects every ``gr.*``
   usage — constructors (with their keyword arguments), namespaces, and
   every event-registration / chain / launch method call.
2. It checks each against ``ALLOWED_GR_API``, the same allowlist as the
   JAX package's test, so any new gr API or kwarg fails until it is added
   here AND implemented in the port's ``app/_gradio_headless.py``.
3. It verifies the port's headless runtime implements the whole allowlist
   (attribute + method existence, constructor kwargs accepted).
"""

import ast
import inspect
from pathlib import Path

import pytest

import audio_raytracing_studio_tpu_torch.app._gradio_headless as hl
from audio_raytracing_studio_tpu_torch.app import studio

STUDIO_SRC = Path(inspect.getsourcefile(studio)).read_text()

# gr.<Name> constructors/functions studio.py may call, mapped to the kwarg
# names that real gradio 4.x accepts for them (None = any kwargs, for
# gr.update whose kwargs are per-component config keys).
ALLOWED_GR_API = {
    "Blocks": {"theme", "title"},
    "Tab": set(),  # positional title only
    "Row": set(),
    "Column": {"scale", "min_width"},
    "Accordion": {"open"},
    "Markdown": {"label", "value"},
    "Audio": {"label", "type", "sources", "show_download_button", "interactive"},
    "File": {"label", "file_types", "interactive"},
    "Checkbox": {"label", "value", "info"},
    "Dropdown": {"choices", "value", "label", "interactive", "allow_custom_value"},
    "Slider": {"minimum", "maximum", "value", "step", "label", "interactive"},
    "Image": {"label", "value", "interactive", "type"},
    "Button": {"variant", "scale"},  # positional value (the caption)
    "Textbox": {"label", "placeholder", "value", "interactive", "lines"},
    "Label": {"label", "value"},
    "update": None,
    "SelectData": None,  # used as a type annotation
    "themes": None,  # namespace: gr.themes.Soft / gr.themes.colors.*
}

EVENT_METHODS = {"change", "click", "input", "select", "upload", "submit",
                 "release"}
ALLOWED_EVENT_KWARGS = {"fn", "inputs", "outputs"}
ALLOWED_LAUNCH_KWARGS = {"server_name", "server_port", "debug", "share"}


def _attr_chain(node):
    """x.y.z Attribute node → ["x", "y", "z"] (or None if not a pure chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class _GrUsage(ast.NodeVisitor):
    def __init__(self):
        self.gr_calls = []  # (api_name, kwarg_names, lineno)
        self.gr_attrs = []  # full chains like ["gr","themes","colors","cyan"]
        self.method_calls = []  # (method_name, kwarg_names, lineno)

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if chain and chain[0] == "gr":
            kwargs = {k.arg for k in node.keywords if k.arg}
            self.gr_calls.append((tuple(chain[1:]), kwargs, node.lineno))
        elif isinstance(node.func, ast.Attribute):
            kwargs = {k.arg for k in node.keywords if k.arg}
            self.method_calls.append((node.func.attr, kwargs, node.lineno))
        self.generic_visit(node)

    def visit_Attribute(self, node):
        chain = _attr_chain(node)
        if chain and chain[0] == "gr":
            self.gr_attrs.append(chain)
        self.generic_visit(node)


@pytest.fixture(scope="module")
def usage():
    u = _GrUsage()
    u.visit(ast.parse(STUDIO_SRC))
    assert u.gr_calls, "studio.py no longer uses gr at all?"
    return u


class TestStudioUsesOnlyAllowedSubset:
    def test_gr_constructors_in_allowlist(self, usage):
        for chain, kwargs, lineno in usage.gr_calls:
            name = chain[0]
            assert name in ALLOWED_GR_API, (
                f"studio.py:{lineno} calls gr.{'.'.join(chain)} — not in the "
                "pinned gradio subset; add it to ALLOWED_GR_API AND implement "
                "it in app/_gradio_headless.py"
            )
            allowed = ALLOWED_GR_API[name]
            if allowed is not None and len(chain) == 1:
                extra = kwargs - allowed
                assert not extra, (
                    f"studio.py:{lineno} passes gr.{name}({sorted(extra)}) — "
                    "kwargs outside the pinned real-gradio surface"
                )

    def test_gr_attribute_namespaces_exist_headless(self, usage):
        for chain in usage.gr_attrs:
            obj = hl
            for part in chain[1:]:
                assert hasattr(obj, part), (
                    f"gr.{'.'.join(chain[1:])} is not implemented by "
                    "_gradio_headless"
                )
                obj = getattr(obj, part)

    def test_event_methods_only_pinned_kwargs(self, usage):
        """Every .change/.click/.then/... call in studio.py sticks to the
        (fn, inputs, outputs) surface; .launch to the reference launch
        config.  (Receivers aren't type-resolved — non-gr methods like
        store.load pass trivially because they use positional args.)"""
        for name, kwargs, lineno in usage.method_calls:
            if name in EVENT_METHODS or name == "then" or name == "load":
                extra = kwargs - ALLOWED_EVENT_KWARGS
                assert not extra, (
                    f"studio.py:{lineno} .{name}({sorted(extra)}) uses kwargs "
                    "outside the pinned event API"
                )
            elif name == "launch":
                extra = kwargs - ALLOWED_LAUNCH_KWARGS
                assert not extra, f"studio.py:{lineno} .launch({sorted(extra)})"


class TestHeadlessImplementsAllowlist:
    def test_every_allowlisted_api_exists(self):
        for name in ALLOWED_GR_API:
            assert hasattr(hl, name), (
                f"ALLOWED_GR_API lists {name!r} but _gradio_headless lacks it"
            )

    def test_constructor_kwargs_accepted(self):
        """Each allowlisted kwarg must be accepted by the headless class —
        explicitly or via **kwargs (how the runtime stores pass-through
        config like gradio does)."""
        for name, allowed in ALLOWED_GR_API.items():
            if not allowed:
                continue
            obj = getattr(hl, name)
            if not inspect.isclass(obj):
                continue
            sig = inspect.signature(obj.__init__)
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
            if has_var_kw:
                continue
            for kw in allowed:
                assert kw in sig.parameters, (name, kw)

    def test_event_methods_exist(self):
        for m in EVENT_METHODS:
            assert callable(getattr(hl.Component, m, None)), m
        assert callable(getattr(hl.Dependency, "then", None))
        assert callable(getattr(hl.Blocks, "load", None))
        assert callable(getattr(hl.Blocks, "launch", None))

    def test_layouts_are_context_managers(self):
        for name in ("Tab", "Row", "Column", "Accordion"):
            cls = getattr(hl, name)
            assert hasattr(cls, "__enter__") and hasattr(cls, "__exit__"), name
