"""One ``spa_layer`` launch (K2): the APP and CtoV rows of the active
frames read once and written once (4 bytes an element for a float32
state, 2 for bfloat16), the index tables and transform tables once,
against two log2(q)-stage transforms and ~7 more operations (subtract,
exp, products, log, add) a symbol."""
import math

from simbench.peaks import bound_ms as _bound

ELEM = {"float32": 4, "bfloat16": 2}


def bound_ms(f_active: int, g: int, dc: int, q: int, config: dict) -> float:
    elem = ELEM[config["decoder"]["dtype"]]
    sym = f_active * g * dc * q
    nbytes = 4 * elem * sym + 3 * 4 * g * dc + 2 * q * q
    return _bound(nbytes, sym * (2 * int(math.log2(q)) + 7))
