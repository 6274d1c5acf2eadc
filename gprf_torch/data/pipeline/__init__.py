"""The seismic data pipeline, scrape -> align -> sort -> combine (a copy of
``gprf_tpu/data/pipeline``, host NumPy): ISC bulletin parsing
(:mod:`gprf_torch.data.pipeline.isf`), waveform alignment by normalized
cross-correlation (:mod:`gprf_torch.data.pipeline.align`), and the catalog
join and sort that writes ``sorted_isc.npy``
(:mod:`gprf_torch.data.pipeline.catalog`).
"""
