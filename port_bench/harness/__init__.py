"""The benchmark's general code: the manifest and its files by name, the
seeded frames, the two drivers (a paced webcam and folder mode), the
trace reduction, the kernels' work counts and the judge's verdict. What
is an architecture's lies in ``archs/<architecture>.py``."""
