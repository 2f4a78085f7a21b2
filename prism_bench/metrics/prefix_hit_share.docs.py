"""Prompt tokens skipped through the radix prefix cache (PREFIX_HIT) over
the prompt tokens of the requests admitted in the window."""


def read(run):
    adm = [r for r in run.recs if run.in_window(r.admit_t)]
    total = sum(len(r.req.prompt) for r in adm)
    return 100.0 * sum(r.skipped for r in adm) / total if total else None
