"""output_tok_s: tokens streamed in the window over the window's seconds."""
from benchkit.loop import output_tok_s


def read(run):
    return output_tok_s(run.window) if run.window.seconds > 0 else None
