"""Offline description preprocessing (counterpart of
`clip_event_tpu/preprocess/`): the rich ColdStart loader (`ke`), the
salient-event selection with its CLIP type scorer (`selection`), the
positive / hard-negative description templates (`templates`) and the IE
pipeline runner (`ie_pipeline`)."""
