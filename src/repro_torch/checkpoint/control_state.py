"""Control-plane checkpointing: the fleet controller's *learned* state as a
checkpoint tree.

The :mod:`repro_torch.checkpoint` layer persists nested dicts of arrays;
here it covers the *controller*, so a crashed fleet loop resumes warm
instead of re-learning its models and forecasts from scratch.  What actually needs to
survive a restart is small and precise:

* every tenant's :class:`~repro_torch.control.learning.ModelStore` —
  node-model fit parameters, the calibration window behind the over-provisioning
  factor, and the monotonic ``version`` counter.  The version matters
  beyond bookkeeping: it is the invalidation token the engine's
  ResultCache and the scheduler's candidate-ladder memo key on, so a
  bit-for-bit restore keeps exactly the right cached results valid,
* every tenant's forecaster (Holt-Winters level/trend/seasonal state,
  replay history, EWMA level),
* the loop's guard memory (last acted-on target and breach flag per
  tenant), so the restarted controller holds/acts exactly where the dead
  one would have.

Everything is encoded as a nested dict whose leaves are numpy-compatible
scalars/arrays — the exact tree shape
:meth:`repro_torch.checkpoint.Checkpointer.save` persists as one ``.npy``
per leaf with an atomic manifest commit.  float64 leaves round-trip bit for
bit through ``np.save``/``np.load``, which is what the restore guarantees
lean on.

Deliberately NOT checkpointed: the deployed :class:`FleetPlan` and the
cluster's host lifecycle.  Placements are *derived* state — the recovered
controller senses the live cluster and replans deterministically — and
host health must be re-observed, never trusted from a file written before
the crash.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..fleet.loop import FleetLoop
    from .checkpointer import Checkpointer


def controller_state(loop: "FleetLoop") -> dict:
    """The fleet loop's learned/guard state as a checkpoint tree."""
    tenants: dict = {}
    for spec in loop.tenants:
        name = spec.name
        if "/" in name:
            raise ValueError(
                f"tenant name {name!r} contains '/', which the checkpoint "
                "tree layout reserves as its key separator"
            )
        entry: dict = {
            "last_target": float(loop._last_target[name]),
            "breached": 1 if loop._breached[name] else 0,
        }
        state_dict = getattr(spec.models, "state_dict", None)
        if callable(state_dict):
            entry["models"] = state_dict()
        if spec.forecaster is not None and hasattr(
            spec.forecaster, "state_dict"
        ):
            entry["forecaster"] = spec.forecaster.state_dict()
        tenants[name] = entry
    return {"step": len(loop.events), "tenants": tenants}


def load_controller_state(loop: "FleetLoop", tree: dict) -> int:
    """Restore :func:`controller_state` into a freshly constructed loop.

    The loop must be built with the same tenant set (same names, same
    forecaster shapes) — structural state lives in code, the checkpoint
    carries only the learned values.  Returns the step count the saved
    controller had reached.  Tenants present in the loop but absent from
    the checkpoint are left cold (a tenant added after the save); saved
    tenants no longer in the loop are ignored (a tenant since retired).
    """
    tenants = tree.get("tenants", {})
    for spec in loop.tenants:
        entry = tenants.get(spec.name)
        if entry is None:
            continue
        loop._last_target[spec.name] = float(entry["last_target"])
        loop._breached[spec.name] = bool(int(entry["breached"]))
        if "models" in entry:
            load = getattr(spec.models, "load_state_dict", None)
            if not callable(load):
                raise ValueError(
                    f"checkpoint carries model state for tenant "
                    f"{spec.name!r} but its spec has no ModelStore"
                )
            load(entry["models"])
        if "forecaster" in entry:
            if spec.forecaster is None:
                raise ValueError(
                    f"checkpoint carries forecaster state for tenant "
                    f"{spec.name!r} but its spec has no forecaster"
                )
            spec.forecaster.load_state_dict(entry["forecaster"])
    return int(tree.get("step", 0))


def save_controller(
    ckpt: "Checkpointer", loop: "FleetLoop", blocking: bool = True
) -> int:
    """Persist the loop's control state at its current step (returns it)."""
    step = len(loop.events)
    ckpt.save(step, controller_state(loop), blocking=blocking)
    return step


def restore_controller(ckpt: "Checkpointer", loop: "FleetLoop") -> "int | None":
    """Load the newest valid checkpoint into ``loop`` (None: nothing saved).

    Returns the step count the saved controller had reached.  The restored
    loop has no deployed plan — its first ``step()`` replans from the live
    cluster — but its models, calibration, forecasters and guard memory
    are bit-for-bit the saved ones, so that replan is the one the dead
    controller would have produced."""
    latest = ckpt.restore_latest()
    if latest is None:
        return None
    _step, tree = latest
    return load_controller_state(loop, tree)
