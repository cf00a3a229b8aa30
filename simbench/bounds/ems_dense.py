"""One ``ems_rows`` launch in K1's dense mode (the exact min-sum check
node at nm = q): the rows of the active frames read once and written once
(float32), against 3 (dc - 2) dense merges a row, each a sum and a minimum
for each of the q^2 candidates (the forward and backward chains, and each
middle slot's extrinsic as the merge of the two)."""
from simbench.peaks import bound_ms as _bound


def bound_ms(f_active: int, g: int, dc: int, q: int, config: dict) -> float:
    rows = f_active * g
    nbytes = 2 * rows * dc * q * 4
    ops = rows * 3 * max(dc - 2, 0) * 2 * q * q
    return _bound(nbytes, ops)
