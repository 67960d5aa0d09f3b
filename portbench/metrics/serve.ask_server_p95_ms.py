"""serve.ask_server_p95_ms (ms): the 95th percentile of the server's
own `serve.ask_ms` histogram over the asks of the window (the obs
plane's window snapshot)."""


def read(ctx):
    v = ctx.extra.get("ask_hist", {}).get("p95")
    return None if v is None else float(v)
