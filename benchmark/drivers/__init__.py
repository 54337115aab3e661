"""One driver per kind of job, found by the name a configuration gives."""
