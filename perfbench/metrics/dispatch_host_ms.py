"""Mean host time of a launch's dispatch: the runtime's
`serve_launch_wall_seconds` (policy choice, layout, enqueue), in ms."""


def read(ctx):
    reg = ctx.window.registry
    if reg is None:
        return None
    h = reg.histogram("serve_launch_wall_seconds")
    return 1e3 * h.total / h.count if h.count else None
