"""Progressive renderer with live edits, cancellation, and checkpoint/resume.

The reference GUI (SURVEY.md §3.3) runs a render thread re-invoking Render()
until max_pass, applies EditQueue material edits between passes, and resets
the accumulation on Rerender (pc/pbrlab-gui.cc:207-238, pc-common.h:14-81,
glfw-window.cc:621-625). The equivalents here:

* a pass is one jitted sample batch; "live edit" is free because material
  parameters are jit INPUTS (pytree leaves), not compiled constants — no
  re-jit, just pass the edited table (the reference instead mutates shared
  memory under a mutex);
* cancel = stop issuing passes (no cooperative flag needed: passes are
  bounded device calls);
* checkpoint/resume persists (accumulator, pass counter, seed) — the spp-
  resume + preemption-tolerance the reference lacks (SURVEY.md §5
  "Checkpoint / resume: none").

Edits address materials by name via the builder's name table, mirroring the
GUI's per-parameter material editor (glfw-window.cc:651-980).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .integrator import render_sample


@dataclasses.dataclass
class Edit:
    """One queued parameter edit (EditQueue::Push analogue)."""

    material: str
    param: str
    value: object


@dataclasses.dataclass
class ReplaceEdit:
    """Whole-material replacement, including the variant type — the
    EditQueue's MaterialParameter payload (pc/pc-common.h:14-81; the GUI
    switches a material between Principled and Hair through it,
    glfw-window.cc:960-975). kind: materials.KIND_*; params: any subset
    of the type's columns, the rest reset to the reference defaults."""

    material: str
    kind: int
    params: Dict


class ProgressiveRenderer:
    """Accumulates passes; applies queued edits between passes."""

    def __init__(self, scene_dev: Dict, width: int, height: int,
                 material_names: Optional[List[str]] = None, seed: int = 0,
                 max_steps: int = 32, k_volume: int = 0):
        self.scene = scene_dev
        self.width = width
        self.height = height
        self.seed = seed
        self.max_steps = max_steps
        # SSS walk-budget substeps; CLI auto-selects (scene_has_sss) so
        # viewer/progressive renders use the same budget as batch renders
        self.k_volume = k_volume
        self.material_names = material_names or []
        self.accum = np.zeros((height, width, 3), np.float32)
        self.num_passes = 0
        self._edit_queue: List[Edit] = []
        self.pass_times: List[float] = []

    # -- edits (EditQueue semantics: applied between passes) -------------
    def queue_edit(self, material: str, param: str, value) -> None:
        self._edit_queue.append(Edit(material, param, value))

    def queue_material_replace(self, material: str, kind: int,
                               params: Optional[Dict] = None) -> None:
        """Replace the whole material — type switch included
        (glfw-window.cc:960-975 semantics). Unspecified parameters reset
        to the reference defaults of material-param.h."""
        self._edit_queue.append(ReplaceEdit(material, kind, params or {}))

    def _apply_edits(self) -> bool:
        if not self._edit_queue:
            return False
        import jax.numpy as jnp

        from ..scene.materials import ALL_COLUMNS

        mats = dict(self.scene["materials"])
        for e in self._edit_queue:
            idx = self.material_names.index(e.material)
            if isinstance(e, ReplaceEdit):
                row = {"kind": e.kind, "base_color_tex_id": -1,
                       "subsurface_color_tex_id": -1}
                for key, default, _ in ALL_COLUMNS:
                    row[key] = e.params.get(key, default)
                unknown = set(e.params) - set(row)
                if unknown:
                    raise ValueError(f"unknown params: {sorted(unknown)}")
                for key, val in row.items():
                    col = mats[key]
                    v = jnp.asarray(val, col.dtype)
                    if col.ndim > 1:
                        v = jnp.broadcast_to(v, col.shape[1:])
                    mats[key] = col.at[idx].set(v)
                continue
            col = mats[e.param]
            val = jnp.asarray(e.value, col.dtype)
            mats[e.param] = col.at[idx].set(val)
        self._edit_queue.clear()
        scene = dict(self.scene)
        scene["materials"] = mats
        scene.pop("mat_fat", None)  # repacked lazily by render_lanes
        self.scene = scene
        return True

    def rerender(self) -> None:
        """Cancel + reset accumulation (RequestRerender semantics)."""
        self.accum[:] = 0
        self.num_passes = 0

    # -- passes -----------------------------------------------------------
    def step(self) -> np.ndarray:
        """Render one pass, fold queued edits in first; returns the running
        average image."""
        import jax
        import jax.numpy as jnp

        if self._apply_edits():
            # edits invalidate the accumulated estimate, like Rerender
            self.rerender()
        t0 = time.time()
        img = render_sample(self.scene, self.width, self.height,
                            jnp.uint32(self.num_passes), seed=self.seed,
                            max_steps=self.max_steps,
                            k_volume=self.k_volume)
        img = np.asarray(jax.block_until_ready(img))
        self.pass_times.append(time.time() - t0)
        self.accum += img
        self.num_passes += 1
        from ..utils import log as plog

        plog.event(plog.get_logger("progressive"), "finish pass",
                   pass_id=self.num_passes,
                   seconds=round(self.pass_times[-1], 4))
        return self.average()

    def render_until(self, max_pass: int,
                     cancel: Optional[Callable[[], bool]] = None,
                     on_pass: Optional[Callable[[int, np.ndarray],
                                                None]] = None) -> np.ndarray:
        """Progressive loop (pbrlab-gui.cc:207-222): render passes until
        max_pass or `cancel()`; `on_pass(i, avg)` is the buffer-update
        callback."""
        while self.num_passes < max_pass:
            if cancel is not None and cancel():
                break
            avg = self.step()
            if on_pass is not None:
                on_pass(self.num_passes, avg)
        return self.average()

    def average(self) -> np.ndarray:
        return self.accum / max(self.num_passes, 1)

    # -- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        np.savez(path, accum=self.accum, num_passes=self.num_passes,
                 seed=self.seed, width=self.width, height=self.height,
                 max_steps=self.max_steps, k_volume=self.k_volume)

    def load_checkpoint(self, path: str) -> None:
        d = np.load(path)
        assert int(d["width"]) == self.width and int(
            d["height"]) == self.height, "checkpoint resolution mismatch"
        self.accum = d["accum"].astype(np.float32)
        self.num_passes = int(d["num_passes"])
        self.seed = int(d["seed"])
        self.max_steps = int(d["max_steps"])
        if "k_volume" in d:  # older checkpoints predate the field
            self.k_volume = int(d["k_volume"])
