"""graph_nodes_per_iter (``.bregman``): the nodes of the captured graph
the cell replays (``_GraphChunk.nodes``, counted at its capture; the
cache's most recently used entry), over the iterations of its span; read
while the caller still holds the cache."""


def read(ctx):
    graphs = getattr(ctx.port.algorithms.driver, "_GRAPHS", {})
    if not graphs:
        return None
    entry = list(graphs.values())[-1]
    nodes = getattr(entry, "nodes", None)
    return None if nodes is None else nodes / entry.span
