"""Frames finished in the window per second of the window."""

def read(obs):
    return obs.frames_done / obs.window_s if obs.frames_done else None
