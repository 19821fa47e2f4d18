"""Pinned device-to-host reads per whole reconstruction job: the
program's ``d2h_pinned`` counted in the traced window (one a read of at
least 1 MiB that lands in page-locked memory, tomojax_torch.host.to_host),
over its ``api.get_recon`` spans. 1 where each job's result volume comes
back pinned; None where no span carries the count (a port without the
pinned route)."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    if got is None or not any("d2h_pinned" in s.counts for s in got):
        return None
    return spans.per_span(got, "d2h_pinned", "api.get_recon")
