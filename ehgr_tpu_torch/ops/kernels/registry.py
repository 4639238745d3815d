"""The port's custom ops (``ehgr::*``): importing this module registers
every one of them, each kernel module registering its own at import.  A
loaded serving artifact needs this and no model code.

``OPS`` maps each op's name to its wrapper, whose ``launches`` counts the
op's kernel launches on the card."""

from ehgr_tpu_torch.ops.kernels import (action_fused, action_mega, int8_conv,
                                        tsm_shift)

OPS = {"ehgr::action_stats": action_mega.action_stats,
       "ehgr::action_apply": action_mega.action_apply,
       "ehgr::action_prologue": action_fused.action_prologue,
       "ehgr::tsm_shift": tsm_shift.tsm_shift,
       "ehgr::int8_conv": int8_conv.int8_conv}
