"""decode.pad_share (%): the share of the frames the decoder ran that no
answer holds, over the Synthesizer's calls in the untraced part of the
window (`benchmark/spans.py`): 100 x (1 - the `inference.call` spans'
`frames_answered` over their `frames_decoded`, each summed). A batch pads
its rows to its longest, and that to the frame bucket of 100."""

from benchmark import spans


def read(run):
    calls = spans.named(spans.untraced(run) or [], "inference.call")
    decoded = sum(c.attrs.get("frames_decoded", 0) for c in calls)
    if decoded <= 0:
        return None
    return 100.0 * (1.0 - sum(c.attrs.get("frames_answered", 0) for c in calls) / decoded)
