"""Every test here sees the ``dsv2_fedstep`` cells registered with the
readings tool (``dsv2_readings``)."""
import dsv2_readings  # noqa: F401
