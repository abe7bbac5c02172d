"""The benchmark's general code: the manifest and its files by name, the
seeded weights and frames, the two drivers (a paced webcam and folder
mode), the trace reduction, the work counts and the judge."""
