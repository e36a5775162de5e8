"""Snippets decoded per second of wall clock in a traced run, outside its
two traced sub-windows: serving's rate as the host sets it. It swings with
the host's speed (the prefetch thread's JPEG decode and the forward's
enqueue), too widely to hold to a bound, so it is read here and not end to
end."""


def read(run):
    if run.get("kind") != "serve":
        return None
    return run.get("rate_untraced")
