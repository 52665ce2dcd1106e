"""semi.unlabeled_row_pct: the unlabeled rows' share of the rows trained on over
the traced stretch: the program's counters ``train.rows_unlabeled`` over
``train.rows_labeled`` + ``train.rows_unlabeled`` (valid rows of each step)."""

from perfbench import spans


def read(ctx):
    c = spans.counters()
    if not c.get("train.rows_unlabeled"):
        return None
    return 100.0 * c["train.rows_unlabeled"] / (c["train.rows_labeled"] + c["train.rows_unlabeled"])
