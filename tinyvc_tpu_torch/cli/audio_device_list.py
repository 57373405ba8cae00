"""CLI: enumerate audio devices (counterpart of
`tinyvc_tpu/cli/audio_device_list.py`). It needs PyAudio and exits with
JAX's message where PyAudio is not installed."""


def main(argv=None):
    try:
        import pyaudio
    except ImportError:
        raise SystemExit("pyaudio is not installed in this environment")

    audio = pyaudio.PyAudio()
    print("list of available audio devices")
    for i in range(audio.get_device_count()):
        data = audio.get_device_info_by_index(i)
        asinput = "Yes" if data["maxInputChannels"] >= 1 else "No"
        asoutput = "Yes" if data["maxOutputChannels"] >= 1 else "No"
        print(f"ID: {i}, Name: {data['name']} [Input: {asinput} Output: {asoutput}]")


if __name__ == "__main__":
    main()
