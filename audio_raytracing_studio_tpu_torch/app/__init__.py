"""The product surfaces: the render API, the 4-tab studio and its headless
HTTP server, the position map, the analyzer UI."""
