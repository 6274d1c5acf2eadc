"""split_leaves_per_eval: the leaf factorizations that the program's
``chol_inv_split`` launched an evaluation, one K1 launch a leaf whatever
its batch: the ``chol_inv`` launches of each job's ``counters.json`` over
its evaluations, sum(launches["chol_inv"]) / sum(evaluations).  K1 runs
nowhere else, so this reads 64 for one block at m = 10,000 (six levels of
the 2x2 split), 8 at the 80k m = 896 (4 in the unary pass, 4 in the pair
pass's splits) and 4 in the local cell.  None where no fit counts them."""

from gprfbench.program_spans import fit_counters


def read(ctx):
    fits = [c for c in fit_counters(ctx) if "chol_inv" in c.get("launches", {})]
    evals = sum(c["evaluations"] for c in fits)
    if not evals:
        return None
    return sum(c["launches"]["chol_inv"] for c in fits) / evals
