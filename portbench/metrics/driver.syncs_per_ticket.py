"""driver.syncs_per_ticket (syncs/ticket): host-device synchronisations
in the window (torch's sync debug mode, `syncs.py`) over the tickets the
Tuner finalized in it (its SearchHook's on_step)."""


def read(ctx):
    n, tickets = ctx.extra.get("syncs"), ctx.extra.get("tickets")
    if n is None or not tickets:
        return None
    return n / tickets
