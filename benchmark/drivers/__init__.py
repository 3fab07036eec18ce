"""Traffic entries: one driver per ``entry`` a traffic file names."""
