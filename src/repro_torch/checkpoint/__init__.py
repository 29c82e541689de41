from .checkpointer import Checkpointer
from .control_state import (
    controller_state,
    load_controller_state,
    restore_controller,
    save_controller,
)

__all__ = [
    "Checkpointer",
    "controller_state",
    "load_controller_state",
    "restore_controller",
    "save_controller",
]
