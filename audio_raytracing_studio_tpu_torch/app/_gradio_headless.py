"""Headless gradio-compatible runtime — build and DRIVE the Blocks UI without gradio.

The port's own copy of ``audio_raytracing_studio_tpu/app/_gradio_headless.py``
(pure Python).  gradio is an optional dependency, yet the studio's 4-tab
Blocks app (raytracer_studio.py:1177-1397) is the reference's
main surface.  This module implements the subset of the gradio API the studio
uses — components, layout context managers, event registration with ``.then()``
chains, ``gr.update``, ``SelectData`` — plus an *executable* event runtime:

    demo = build_demo()                       # works with or without gradio
    demo.set_value("🔊 Audio hochladen", path)
    demo.fire(demo.get("➡️ Verarbeiten & Anhören!"), "click")
    demo.get("🎧 Ergebnis anhören").value     # → rendered WAV path

Semantics mirror gradio's event model:
- handlers receive the *current values* of their ``inputs`` components,
- a ``SelectData``-annotated parameter gets the event data injected,
- return values are fanned out to ``outputs`` (len-checked, like gradio),
- ``gr.update(...)`` dicts patch component config (value/choices/interactive/...),
- ``.then()`` steps run after their parent, in registration order,
- every listener registered on the same (component, event) fires.

This is the framework's own UI runtime, not a mock: the real studio wiring
executes through it end-to-end in the tests (tests/test_torch_studio.py),
which is how the event graph is verified where gradio is absent.
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

log = logging.getLogger("ars_torch.headless_ui")

_ctx = threading.local()


def _blocks_stack() -> List["Blocks"]:
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


def update(**kwargs) -> Dict[str, Any]:
    """gradio-style partial component update (a plain dict, like gr.update)."""
    out = dict(kwargs)
    out["__type__"] = "update"
    return out


class SelectData:
    """Event payload for ``.select`` listeners (mirrors gradio.SelectData)."""

    def __init__(self, index=None, value=None, selected: bool = True):
        self.index = index
        self.value = value
        self.selected = selected


class Dependency:
    """One registered event step; ``.then`` chains a follow-up step."""

    def __init__(self, blocks: "Blocks", trigger, event: str, fn, inputs, outputs):
        self.blocks = blocks
        self.trigger = trigger
        self.event = event
        self.fn = fn
        self.inputs = _as_list(inputs)
        self.outputs = _as_list(outputs)
        self.after: List["Dependency"] = []

    def then(self, fn=None, inputs=None, outputs=None, **_):
        dep = Dependency(self.blocks, self, "then", fn, inputs, outputs)
        self.after.append(dep)
        self.blocks._all_deps.append(dep)
        return dep


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Component:
    """Base for all components: config kwargs + event registration."""

    EVENTS = ("change", "click", "input", "select", "upload", "release", "submit")

    def __init__(self, value=None, *, label=None, **kwargs):
        self.label = label
        self.value = value() if callable(value) else value
        self.choices = kwargs.pop("choices", None)
        self.interactive = kwargs.pop("interactive", True)
        self.visible = kwargs.pop("visible", True)
        self.config = kwargs
        self.blocks: Optional[Blocks] = None
        # innermost enclosing Tab title (for structural rendering), if any
        self.tab: Optional[str] = next(
            (l.title for l in reversed(_layout_stack()) if isinstance(l, Tab)),
            None,
        )
        stack = _blocks_stack()
        if stack:
            stack[-1]._register(self)

    # --- event registration (gradio API) ---
    def _listen(self, event: str, fn, inputs, outputs) -> Dependency:
        blocks = self.blocks or (_blocks_stack()[-1] if _blocks_stack() else None)
        if blocks is None:
            raise RuntimeError("event registered outside a Blocks context")
        dep = Dependency(blocks, self, event, fn, inputs, outputs)
        blocks._all_deps.append(dep)
        return dep

    def change(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("change", fn, inputs, outputs)

    def click(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("click", fn, inputs, outputs)

    def input(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("input", fn, inputs, outputs)

    def select(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("select", fn, inputs, outputs)

    def upload(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("upload", fn, inputs, outputs)

    def submit(self, fn=None, inputs=None, outputs=None, **_):
        return self._listen("submit", fn, inputs, outputs)

    def release(self, fn=None, inputs=None, outputs=None, **_):
        # gradio's idiomatic end-of-drag event for sliders; EVENTS advertises
        # it, so the registration method must exist too
        return self._listen("release", fn, inputs, outputs)

    def __repr__(self):
        return f"<{type(self).__name__} label={self.label!r} value={self.value!r}>"


class Audio(Component):
    pass


class Checkbox(Component):
    def __init__(self, value=False, **kwargs):
        super().__init__(value=value, **kwargs)


class File(Component):
    pass


class Dropdown(Component):
    def __init__(self, choices=None, value=None, **kwargs):
        super().__init__(value=value, choices=list(choices or []), **kwargs)


class Textbox(Component):
    def __init__(self, value="", **kwargs):
        super().__init__(value=value, **kwargs)


class Slider(Component):
    def __init__(self, minimum=0.0, maximum=1.0, value=None, step=None, **kwargs):
        self.minimum = minimum
        self.maximum = maximum
        self.step = step
        super().__init__(value=value if value is not None else minimum, **kwargs)


class Image(Component):
    pass


class Button(Component):
    def __init__(self, value="Run", variant="secondary", **kwargs):
        kwargs.setdefault("label", value)
        super().__init__(value=value, **kwargs)
        self.variant = variant


class Label(Component):
    pass


class Markdown(Component):
    def __init__(self, value="", **kwargs):
        super().__init__(value=value, **kwargs)


class Number(Component):
    def __init__(self, value=0, **kwargs):
        super().__init__(value=value, **kwargs)


def _layout_stack() -> List["_Layout"]:
    if not hasattr(_ctx, "layouts"):
        _ctx.layouts = []
    return _ctx.layouts


class _Layout:
    """Row/Column/Tab/Accordion — structural contexts.  They do not affect
    event semantics, but the nesting is recorded on each component so the
    HTTP server (app/server.py) can render the real tab/row structure."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs
        self.title = args[0] if args and isinstance(args[0], str) else kwargs.get("label")

    def __enter__(self):
        _layout_stack().append(self)
        return self

    def __exit__(self, *exc):
        _layout_stack().pop()
        return False


class Row(_Layout):
    pass


class Column(_Layout):
    pass


class Tab(_Layout):
    pass


TabItem = Tab


class Accordion(_Layout):
    pass


class Group(_Layout):
    pass


class _ColorNamespace:
    def __getattr__(self, name: str) -> str:
        return name


class _Theme:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs


class _ThemesNamespace:
    colors = _ColorNamespace()
    Soft = _Theme
    Default = _Theme
    Base = _Theme
    Glass = _Theme
    Monochrome = _Theme


themes = _ThemesNamespace()


class Blocks:
    """Executable headless Blocks: registry + event runtime."""

    def __init__(self, *, theme=None, title: str = "", **kwargs):
        self.theme = theme
        self.title = title
        self.config = kwargs
        self.components: List[Component] = []
        self._all_deps: List[Dependency] = []

    # --- construction context ---
    def __enter__(self):
        _blocks_stack().append(self)
        return self

    def __exit__(self, *exc):
        _blocks_stack().pop()
        return False

    def _register(self, comp: Component):
        comp.blocks = self
        self.components.append(comp)

    def load(self, fn=None, inputs=None, outputs=None, **_):
        dep = Dependency(self, self, "load", fn, inputs, outputs)
        self._all_deps.append(dep)
        return dep

    def launch(self, server_name: str = "0.0.0.0", server_port: int = 8861, **_):
        """Serve this Blocks over HTTP with the framework's own stdlib
        server (app/server.py) — the gradio-free equivalent of
        gr.Blocks.launch (reference: raytracer_studio.py:1397)."""
        from .server import serve

        serve(self, host=server_name, port=server_port)

    # --- driving the Blocks without a browser ---
    def get(self, label: str) -> Component:
        """First component whose label matches (startswith fallback)."""
        matches = self.get_all(label)
        if not matches:
            raise KeyError(f"no component labeled {label!r}")
        return matches[0]

    def get_all(self, label: str) -> List[Component]:
        exact = [c for c in self.components if c.label == label]
        if exact:
            return exact
        return [
            c
            for c in self.components
            if isinstance(c.label, str) and c.label.startswith(label)
        ]

    def set_value(self, label: str, value, *, fire_change: bool = False):
        comp = self.get(label)
        comp.value = value
        if fire_change:
            self.fire(comp, "change")
        return comp

    def deps_for(self, trigger, event: str) -> List[Dependency]:
        return [
            d for d in self._all_deps if d.trigger is trigger and d.event == event
        ]

    def startup(self):
        """Run all Blocks.load dependencies (the startup initializer)."""
        for dep in self.deps_for(self, "load"):
            self._run_chain(dep)

    def fire(self, component, event: str = "click", event_data=None):
        """Fire every listener registered on (component, event), in order."""
        if isinstance(component, str):
            component = self.get(component)
        deps = self.deps_for(component, event)
        if not deps:
            raise KeyError(f"no {event!r} listener on {component!r}")
        for dep in deps:
            self._run_chain(dep, event_data)

    # --- event execution (gradio semantics) ---
    def _run_chain(self, dep: Dependency, event_data=None):
        self._run_one(dep, event_data)
        for child in dep.after:
            self._run_chain(child, event_data=None)  # .then gets no event data

    def _run_one(self, dep: Dependency, event_data=None):
        if dep.fn is None:
            return
        args = [c.value for c in dep.inputs]
        fn = dep.fn
        if event_data is not None and _wants_event_data(fn):
            args = [event_data] + args
        result = fn(*args)
        self._apply(dep.outputs, result, fn)

    def _apply(self, outputs: List[Component], result, fn):
        if not outputs:
            return
        if len(outputs) == 1:
            values: Sequence[Any] = [result]
        else:
            if not isinstance(result, (list, tuple)):
                raise ValueError(
                    f"handler {getattr(fn, '__name__', fn)!r} returned a single "
                    f"value for {len(outputs)} outputs"
                )
            if len(result) != len(outputs):
                raise ValueError(
                    f"handler {getattr(fn, '__name__', fn)!r} returned "
                    f"{len(result)} values for {len(outputs)} outputs"
                )
            values = result
        for comp, val in zip(outputs, values):
            _apply_value(comp, val)


def _wants_event_data(fn: Callable) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        ann = p.annotation
        if ann is SelectData or (isinstance(ann, str) and "SelectData" in ann):
            return True
        if p.name in ("evt", "event") and ann is inspect.Parameter.empty:
            return True
    return False


def _apply_value(comp: Component, val):
    if isinstance(val, dict) and val.get("__type__") == "update":
        patch = {k: v for k, v in val.items() if k != "__type__"}
        for key, v in patch.items():
            if key in ("value", "choices", "interactive", "visible", "label"):
                setattr(comp, key, v)
            else:
                comp.config[key] = v
    else:
        comp.value = val
