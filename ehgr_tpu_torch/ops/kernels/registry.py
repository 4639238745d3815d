"""The port's custom ops (``ehgr::*``): importing this module registers
every one of them, each kernel module registering its own at import.  A
loaded serving artifact needs this and no model code.

``OPS`` maps each op's name to its wrapper, whose ``launches`` counts the
op's kernel launches on the card.  ``KERNELS`` names every hand-written
kernel's wrapper, the ops' and the learnable shift's two (no op: its
autograd function calls them), each with its ``launches`` counter
(``utils.profiling.launch_counts`` reads them all)."""

from ehgr_tpu_torch.ops.kernels import (action_fused, action_mega, int8_conv,
                                        shift, tsm_shift)

OPS = {"ehgr::action_stats": action_mega.action_stats,
       "ehgr::action_apply": action_mega.action_apply,
       "ehgr::action_prologue": action_fused.action_prologue,
       "ehgr::tsm_shift": tsm_shift.tsm_shift,
       "ehgr::int8_conv": int8_conv.int8_conv}

KERNELS = {**{name.split("::")[1]: wrapper for name, wrapper in OPS.items()},
           "learnable_shift_fwd": shift.learnable_shift_fwd,
           "learnable_shift_bwd": shift.learnable_shift_bwd}
