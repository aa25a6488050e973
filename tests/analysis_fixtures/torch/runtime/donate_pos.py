"""NOS020 positives for the PyTorch rules: a replayed graph's static output
read after a later replay of the same graph rewrote it — a local, a
`self.attr`, an output handed out by a function of this file that returns
a replay's output, and a loop whose replay rewrites an output bound before
the loop that the loop reads but never rebinds."""


class Engine:
    def __init__(self, graph):
        self._graph = graph

    def _window(self):
        out = self._graph.replay()
        return out

    def read_after_second_replay(self):
        first = self._graph.replay()
        second = self._graph.replay()
        return first.sum(), second  # NOS020

    def self_attr_after_replay(self):
        self._last = self._graph.replay()
        self._graph.replay()
        return self._last  # NOS020

    def through_the_returner(self):
        toks = self._window()
        more = self._window()
        return toks, more  # NOS020

    def loop_back_edge(self, g, n):
        out = g.replay()
        rows = []
        for _ in range(n):
            rows.append(out.tolist())
            g.replay()  # NOS020
        return rows
