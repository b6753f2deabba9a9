"""The service layer of the port.  So far only the batched ingest the
estimators need (:mod:`.ingest`)."""
