"""prefill_mfu (kernels of the prefill): the FLOPs of the prefill chunks
dispatched in the measured part of the window, each at its true start, over
their fenced dispatch time times the card's bf16 peak, in percent. A
chunk's LM-head row counts only where the prompt ends."""


def read(run):
    spans = run.spans_named("prefill_chunk")
    seconds = sum(s.seconds for s in spans)
    if not seconds:
        return None
    by_rid = run.served_by_rid()
    flops = 0
    for s in spans:
        start, n = s.args["start"], s.args["chunk"]
        last = start + n == by_rid[s.args["rid"]].prompt_len
        flops += run.shape.chunk_flops(start, n, logits_last=last)
    return 100.0 * flops / (seconds * run.peaks["bf16_flop_s"])
