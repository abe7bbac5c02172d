"""The network's FLOPs per frame times frames_per_s over the card's peak in
the configuration's precision, percent."""

from port_bench.harness.readers import step_mfu_pct


def read(obs):
    return step_mfu_pct(obs, obs.frames_done / obs.window_s)
