"""Share of the window's decode steps that took a per-step decode megakernel
(the `launches` counters of `fused_decode_step` and
`fused_decode_step_big` over the decode steps): the Generator's route
choice (`_fused_ok`). The chunk megakernel, one launch for many steps, is
not counted."""

from benchmark.harness import readers

LAYER = "Generator route (serving/generate.py)"
UNIT = "%"
MOVES = "output_tokens_per_s.b1"
SOURCE = "program_counter"


def read(ctx):
    return readers.megakernel_share(ctx)
