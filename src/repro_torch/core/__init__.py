"""TIDAL's core mechanisms, ported: strict-traced initialization
(``fingerprint``, ``api``), weight-access tracing (``tracing``), function
templates (``merging``, ``template``), copy-on-write guards (``forking``),
layer-streamed forks (``streaming``), the template server
(``template_server``) and proactive code loading (``prewarm``)."""
