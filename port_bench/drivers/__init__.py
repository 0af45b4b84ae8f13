"""One driver for each kind of path; a configuration names its driver."""
