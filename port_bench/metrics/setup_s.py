"""Seconds from process start to the first timed frame."""

def read(obs):
    return obs.setup_s
