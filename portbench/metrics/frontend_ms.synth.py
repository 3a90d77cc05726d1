"""Front end of a synth call, ms: its span less its solve's collect span
(encoding, solve state, ranking the lanes, the trace to a solution, the
circuit), over the window's calls."""


def read(run):
    synth, collect = run.spans.get("synth"), run.spans.get("collect")
    if not synth or not collect or len(synth) != len(collect):
        return None
    return 1e3 * (sum(synth) - sum(collect)) / len(synth)
