"""Streaming-ingest example: miniSEED records -> ring buffer -> monitor.

The port's counterpart of ``examples/example_streaming_ingest.py``.  It
simulates a live station feed: a long synthetic event is cut into records
(one per channel-chunk, delivered with per-channel jitter like a real
telemetry link), pushed through the port's ring buffer (`io.ingest`, native
where ``g++`` built the host runtime), and every completed segment is
processed and persisted by `StreamingMonitor` (checkpoint/resume TSV+npz).
Run (offline, synthetic data):

    python -m narrow_band_least_squares_tpu_torch.examples.example_streaming_ingest [--cpu]

Results go to ``build/torch_examples/streaming_out/``.
"""

import os

import numpy as np

from narrow_band_least_squares_tpu_torch.examples import OUT_ROOT, device_from_argv
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.io.ingest import MSRecord, StreamingIngest
from narrow_band_least_squares_tpu_torch.models.streaming import StreamingMonitor
from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.utils.plan import (
    get_freqlist,
    get_winlenlist,
    make_plan,
)

NCHANS, FS, DURATION_S = 8, 20.0, 3600.0
FMIN, FMAX, NBANDS = 0.1, 5.0, 8
WINLEN, WINLEN_1, WINLEN_X = 50, 60, 30
SEGMENT_S = 600.0
RECORD_SAMPLES = 400          # samples per simulated record
SAVE_DIR = os.path.join(OUT_ROOT, "streaming_out")


def main(argv=None):
    device = device_from_argv(argv)

    # 1) one hour of synthetic plane-wave data = the "station"
    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=DURATION_S, fs=FS, baz_deg=230.0,
        trace_vel_kms=0.34, f0=0.8, bandwidth=1.2, snr=8.0, seed=7,
    )
    seg_npts = int(SEGMENT_S * st.fs)

    # 2) the monitoring pipeline (per-segment plan) and the ingest front-end
    freqlist, nbands, _ = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, 0.5, seg_npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    ingest = StreamingIngest(
        st.ids, fs=st.fs, segment_npts=seg_npts,
        latitudes=st.latitudes, longitudes=st.longitudes,
    )

    # 3) simulate telemetry: per-channel record streams with jitter
    rng = np.random.default_rng(0)
    feed = []
    for c, sid in enumerate(st.ids):
        lag = rng.integers(0, 3)                   # channel arrives late
        for k in range(0, st.npts, RECORD_SAMPLES):
            feed.append((k + lag * RECORD_SAMPLES, MSRecord(
                sid, st.start_epoch + k / st.fs, st.fs,
                st.data[c, k : k + RECORD_SAMPLES],
            )))
    feed.sort(key=lambda kv: kv[0])                # arrival order

    done = 0
    with StreamingMonitor(plan, rij, SAVE_DIR, freqlist, alpha=1.0,
                          device=device) as monitor:
        for _, rec in feed:
            ingest.feed_records([rec])
            for segment in ingest.ready_segments():
                recs = monitor.process(segment, resume=True)
                done += len(recs)
                print(f"segment @ {segment.start_epoch:.0f}s processed "
                      f"({len(recs)} new, ring native={ingest.ring.is_native})")
        print(f"{done} segments persisted under {SAVE_DIR}")
        vel, baz, mdccm, t, num = monitor.read_all()

    good = mdccm > 0.6
    print(f"median back-azimuth over {int(good.sum())} confident windows: "
          f"{np.median(baz[good]):.1f} deg (true 230.0)")
    return done, baz[good]


if __name__ == "__main__":
    main()
