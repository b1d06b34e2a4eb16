"""Traffic: one general generator (generator.py) and the mixes it reads, one
data file each (`<traffic name>.json`)."""
