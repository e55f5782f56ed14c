"""decode.device_ms_per_audio_s (ms/audio_s): the decode graphs' own time
on the card (the `decode` spans' `device_ms`, from timing events that are
the graph's first and last nodes) summed over the Synthesizer's calls in
the untraced part of the window (`benchmark/spans.py`), over the seconds of
audio those calls answered (their `frames_answered`, 40 frames a second)."""

from benchmark import spans


def read(run):
    got = spans.untraced(run)
    if not got:
        return None
    calls = spans.named(got, "inference.call")
    decodes = spans.children(got, calls, "decode")
    ms = [d.attrs.get("device_ms") for c in calls for d in decodes[c.id]]
    audio_s = sum(c.attrs.get("frames_answered", 0) for c in calls) / spans.FRAMES_PER_S
    if not ms or any(m is None for m in ms) or audio_s <= 0:
        return None
    return sum(ms) / audio_s
