"""One ``list_layer`` launch (K3): the APP rows and the compressed CtoV
(one element a value, one byte a GF id, one element the level) of the
active frames read once and written once, against the operations: the VN
extrinsic, its minimum and the two dense expansions (6 a symbol), and
3 (dc - 2) merges of a sum and a min a candidate, the staircase's
{(i + 1)(j + 1) <= nbOper} or all nm^2 in the exact mode (nbOper <= 0)."""
from simbench.peaks import bound_ms as _bound

ELEM = {"float32": 4, "bfloat16": 2}


def staircase_pairs(nm: int, nboper: int) -> int:
    w = min(nboper, nm * nm)
    return sum(min(nm, w // (i + 1)) for i in range(nm))


def bound_ms(f_active: int, g: int, dc: int, q: int, config: dict) -> float:
    dec = config["decoder"]
    elem, nm, nboper = ELEM[dec["dtype"]], dec["nm"], dec["nboper"]
    pairs = nm * nm if nboper <= 0 else staircase_pairs(nm, nboper)
    nbytes = 2 * f_active * g * dc * (q * elem + nm * (elem + 1) + elem)
    ops = f_active * g * (6 * dc * q + 3 * max(dc - 2, 0) * 2 * pairs)
    return _bound(nbytes, ops)
