"""Mean ms of the program's own ``pack_problem`` span: the host's time
in Eq. 17's pack (the span ends when its last work is enqueued)."""


def read(rec):
    spans = rec.pack_spans
    return sum(spans) / len(spans) * 1e3 if spans else None
