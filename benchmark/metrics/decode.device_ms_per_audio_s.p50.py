"""decode.device_ms_per_audio_s.p50: decode.device_ms_per_audio_s
(`decode.device_ms_per_audio_s.py`) in the cells whose tail is not an
end-to-end metric, where it moves latency_p50_ms."""

from pathlib import Path

from benchmark import spec

read = spec.reader(Path(__file__).resolve().parents[1], "decode.device_ms_per_audio_s")
