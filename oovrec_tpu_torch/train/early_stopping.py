"""Early stopping (`recbole/utils/utils.py:115-156` exact semantics).

A copy of `oovrec_tpu/train/early_stopping.py`.
"""

from __future__ import annotations


def early_stopping(value, best, cur_step, max_step, bigger=True):
    """Returns (best, cur_step, stop_flag, update_flag)."""
    stop_flag = False
    update_flag = False
    if best is None:
        best = value
        update_flag = True
        return best, 0, stop_flag, update_flag
    if bigger:
        if value > best:
            cur_step = 0
            best = value
            update_flag = True
        else:
            cur_step += 1
            if cur_step > max_step:
                stop_flag = True
    else:
        if value < best:
            cur_step = 0
            best = value
            update_flag = True
        else:
            cur_step += 1
            if cur_step > max_step:
                stop_flag = True
    return best, cur_step, stop_flag, update_flag
