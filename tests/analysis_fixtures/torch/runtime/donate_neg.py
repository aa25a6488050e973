"""NOS020 negatives for the PyTorch rules: every replay's output is cloned
or copied out before the next replay, rebound from it in the same
statement, returned straight out of the frame, or never read again; other
graphs, `replay(...)` calls with arguments (not a graph), and nested
bodies are not tracked."""


class Engine:
    def __init__(self, graph):
        self._graph = graph

    def clone_first(self):
        first = self._graph.replay().clone()
        second = self._graph.replay()
        return first, second

    def copy_out_before_replay(self, buf):
        out = self._graph.replay()
        buf.copy_(out)
        keep = out.clone()
        self._graph.replay()
        return keep, buf

    def rebind_same_statement(self):
        out = self._graph.replay()
        out = self._graph.replay()
        return out

    def rebind_in_loop(self, g, n):
        rows = []
        for _ in range(n):
            out = g.replay()
            rows.append(out.tolist())
        return rows

    def different_graphs(self, a, b):
        x = a.replay()
        y = b.replay()
        return x, y

    def rebound_before_read(self):
        out = self._graph.replay()
        self._graph.replay()
        out = self._fresh()
        return out

    def returns_the_next_replay(self):
        out = self._graph.replay()
        total = out.sum()
        return total, self._graph.replay()

    def monitor_replay_is_not_a_graph(self, monitor, reports):
        a = monitor.replay(reports)
        b = monitor.replay(reports)
        return a, b

    def nested_body_is_skipped(self):
        def inner():
            first = self._graph.replay()
            self._graph.replay()
            return first

        return inner

    def _fresh(self):
        return None
