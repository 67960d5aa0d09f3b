"""The general window loops.  A traffic mix's `driver` names one of
these modules; each reads its mix's parameters and its configuration,
builds the system under test, warms it up, measures for the window, and
judges what the window produced against the plain reference."""
