"""Traffic generators, one module per kind, found by the ``generator`` key
of a traffic file. Each module has ``pool(traffic, model, seed,
count=None)``, the list of host batches (dicts of numpy arrays) that the
window cycles through, or its first ``count``: ``traffic`` is the traffic
file's dict, ``model`` the configuration's model arguments, ``seed`` the
run's data seed. The same arguments give the same arrays."""
