"""Adjustable-parameter panel: the reference's Param/ParamListGL equivalent.

The reference renders GL slider bars whose Param<float> objects write through
raw pointers into the live NBodyParams
(the reference's src/nbody/param.hpp:61-101, paramgl.hpp:41-60). Here each
AdjustableParam has the same (name, value, min, max, step) tuple and
percentage get/set, and the panel writes through a callback into the engine's
live params (which are dynamic kernel inputs — no recompilation). Rendered as
text (`render_text`) instead of GL quads; driven by keys or --set flags.
"""

from __future__ import annotations

from typing import Callable, Dict, List


class AdjustableParam:
    def __init__(self, name: str, value: float, vmin: float, vmax: float, step: float):
        if vmin > vmax:
            raise ValueError(f"{name}: min {vmin} > max {vmax}")
        self.name = name
        self.min = vmin
        self.max = vmax
        self.step = step
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    @value.setter
    def value(self, v: float) -> None:
        self._value = min(max(float(v), self.min), self.max)

    # percentage interface (the reference's get/set_percentage)
    @property
    def percentage(self) -> float:
        if self.max == self.min:
            return 0.0
        return (self._value - self.min) / (self.max - self.min)

    @percentage.setter
    def percentage(self, p: float) -> None:
        self.value = self.min + (self.max - self.min) * min(max(p, 0.0), 1.0)

    def increment(self) -> None:
        self.value = self._value + self.step

    def decrement(self) -> None:
        self.value = self._value - self.step


class ParamPanel:
    """Named params + write-through to the engine (the slider list)."""

    # the reference's five sliders with their ranges
    # (the reference's src/nbody/compute.cpp:273-285)
    REFERENCE_SLIDERS = (
        ("velocity_damping", 0.5, 1.0, 0.0001),
        ("softening_factor", 0.001, 1.0, 0.0001),
        ("time_step", 0.0, 1.0, 0.0001),
        ("cluster_scale", 0.0, 10.0, 0.01),
        ("velocity_scale", 0.0, 1000.0, 0.1),
    )

    def __init__(self, write_through: Callable[[str, float], None]):
        self._write = write_through
        self.params: Dict[str, AdjustableParam] = {}
        self.order: List[str] = []
        self.selected = 0

    def add(self, name: str, value: float, vmin: float, vmax: float, step: float) -> AdjustableParam:
        p = AdjustableParam(name, value, vmin, vmax, step)
        self.params[name] = p
        self.order.append(name)
        return p

    @classmethod
    def for_compute(cls, compute) -> "ParamPanel":
        """Panel wired to a Compute engine with the reference's sliders."""
        field_map = {
            "velocity_damping": "damping",
            "softening_factor": "softening",
            "time_step": "time_step",
            "cluster_scale": "cluster_scale",
            "velocity_scale": "velocity_scale",
        }

        def write(name: str, value: float) -> None:
            compute.update_params(**{field_map[name]: value})

        panel = cls(write)
        ap = compute.active_params
        for name, vmin, vmax, step in cls.REFERENCE_SLIDERS:
            panel.add(name, getattr(ap, field_map[name]), vmin, vmax, step)
        return panel

    def set(self, name: str, value: float) -> None:
        if name not in self.params:
            raise KeyError(f"unknown parameter {name!r}; have {self.order}")
        self.params[name].value = value
        self._write(name, self.params[name].value)

    # keyboard navigation (the reference's arrow keys on the GL panel)
    def select_next(self) -> None:
        self.selected = (self.selected + 1) % len(self.order)

    def select_previous(self) -> None:
        self.selected = (self.selected - 1) % len(self.order)

    def adjust_selected(self, direction: int) -> None:
        name = self.order[self.selected]
        p = self.params[name]
        (p.increment if direction > 0 else p.decrement)()
        self._write(name, p.value)

    def render_text(self) -> str:
        """Text slider bars (the GL quads become ASCII)."""
        lines = []
        for i, name in enumerate(self.order):
            p = self.params[name]
            width = 24
            filled = int(round(p.percentage * width))
            bar = "#" * filled + "-" * (width - filled)
            cursor = ">" if i == self.selected else " "
            lines.append(f"{cursor} {name:18s} [{bar}] {p.value:g}")
        return "\n".join(lines)
