"""``step_mfu.*`` (%): the whole step's share of the card's int8 peak.

Model operations (2 x every multiply-accumulate the outputs need,
counted once, not once per bit plane: the macro's products, the digital
ones and attention over the cache; the head only where its logits are
used) over the unprofiled window of the traced run, whose length counts
every call whole, against 1,979 TOP/s.
"""

from perfbench import peaks


def read(rec):
    if rec.window_s <= 0 or rec.calls == 0:
        return None
    ops = 2.0 * rec.cell.model_macs() * rec.calls
    return 100.0 * ops / rec.window_s / peaks.INT8_OPS_PER_S
