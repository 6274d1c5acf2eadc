"""setup_s: seconds from the start of the process to the start of the
window (imports, the card, the data of the seed, the kernel library, the
warm-up job)."""


def read(ctx):
    return ctx.setup_s
