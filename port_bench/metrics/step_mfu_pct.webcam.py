"""The network's FLOPs per frame times the frames delivered per second of
the window, over the card's peak in the configuration's precision,
percent."""

from port_bench.harness.readers import step_mfu_pct


def read(obs):
    return step_mfu_pct(obs, obs.delivered / obs.window_s)
