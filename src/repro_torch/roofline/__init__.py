"""The roofline of a step (``repro.roofline``): ``count.py`` counts what a
call dispatches (FLOPs, bytes, collectives, memory, kernel calls), the
counterpart of the reference's HLO parse; ``analysis.py`` turns the dry
run's records (``launch/dryrun.py``) into compute, memory and collective
terms on the H100."""
